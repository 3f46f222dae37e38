"""Expert UID grid naming and expert records (the port's copy of
hivemind_tpu/moe/expert_uid.py).

Experts live on a named grid: ``prefix.i.j.k`` — each dot-separated integer indexes one
grid dimension. Beam search walks prefixes left to right."""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

from hivemind_tpu_torch.p2p.peer_id import PeerID

ExpertUID = str
ExpertPrefix = str

UID_DELIMITER = "."
FLAT_EXPERT = -1

# The client/server contract for retry safety on ambiguous connection loss:
# rpc_info is a pure read and rpc_forward is side-effect-free (inference only);
# rpc_backward (steps the expert optimizer) and rpc_decode (advances a KV-cache
# session) must fail loudly instead of risking a double-applied side effect.
# Single source of truth for ConnectionHandler._idempotent_rpcs AND the direct
# call sites in client/expert.py.
IDEMPOTENT_CONNECTION_RPCS = frozenset({"rpc_info", "rpc_forward"})
UID_PATTERN = re.compile(r"^(([^.])+)([.](?:[0]|([1-9]([0-9]*))))+$")
PREFIX_PATTERN = re.compile(r"^(([^.])+)([.](?:[0]|([1-9]([0-9]*))))*[.]$")


def is_valid_uid(maybe_uid: str) -> bool:
    return bool(UID_PATTERN.fullmatch(maybe_uid))


def is_valid_prefix(maybe_prefix: str) -> bool:
    return bool(PREFIX_PATTERN.fullmatch(maybe_prefix))


def split_uid(uid_or_prefix: str) -> Tuple[ExpertPrefix, int]:
    """'ffn.5.12' -> ('ffn.5.', 12)"""
    uid_or_prefix = uid_or_prefix.rstrip(UID_DELIMITER)
    pivot = uid_or_prefix.rindex(UID_DELIMITER) + 1
    return uid_or_prefix[:pivot], int(uid_or_prefix[pivot:])


class ReplicaInfo(NamedTuple):
    """One server hosting an expert: its peer id plus the wire dtype that
    server's declaration advertised (None = unknown, negotiate via rpc_info)."""

    peer_id: PeerID
    compression: Optional[str] = None


class ExpertInfo(NamedTuple):
    uid: ExpertUID
    peer_id: PeerID
    # the server's advertised wire dtype for activations ("float16", "none", …)
    # when its DHT declaration carried one; None = unknown (the client falls
    # back to the rpc_info negotiation on first use)
    compression: Optional[str] = None
    # the FULL replica set declared for this uid, primary included;
    # None/empty = single-replica record (peer_id is the only server). peer_id
    # above is the *selected* primary — clients load-balance across `replicas`
    # by scorecard latency with breaker-aware failover (moe/client/expert.py)
    replicas: Optional[Tuple[ReplicaInfo, ...]] = None

    @property
    def replica_set(self) -> Tuple[ReplicaInfo, ...]:
        """Every known replica (always non-empty; falls back to the primary)."""
        if self.replicas:
            return self.replicas
        return (ReplicaInfo(self.peer_id, self.compression),)
