"""Expert discovery records (the port's copy of
hivemind_tpu/moe/server/dht_handler.py): an expert's UID and EVERY prefix of it are
stored as dictionary subkeys, which is what makes left-to-right beam search over the
grid possible.

Record format: each stored value is ``<peer_b58>`` or ``<peer_b58>|<compression>``,
the string the JAX package writes, so a JAX client resolves a port server and the
reverse. Servers append their advertised activation wire dtype, so clients learn
the negotiated codec from discovery alone, without an extra ``rpc_info``
round-trip. The *leaf* record is a **multi-value replica set**: each server stores
its record under its own peer-id subkey, so the DHT merges concurrent declarations
subkey-wise instead of newest-expiration-wins; the key's value deserializes to
``{peer_b58: (record, expiration)}`` and resolution returns the FULL replica set
(``ExpertInfo.replicas``). Readers accept every form (bare peer, ``peer|codec``,
subkey dictionaries). Prefix records keep their coordinate subkeys (beam search
only needs coordinate existence; replica resolution happens at the leaf)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe.expert_uid import (
    UID_DELIMITER,
    ExpertInfo,
    ExpertUID,
    ReplicaInfo,
    is_valid_uid,
    split_uid,
)
from hivemind_tpu_torch.p2p import PeerID
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

_RECORD_DELIMITER = "|"

# Replica-set leaf reads run the FULL merging traversal (get_many with an
# unreachable sufficient_expiration_time, i.e. `latest` semantics) instead of
# finishing at the first fresh value. Rationale: a replica-set leaf is
# MERGE-typed — any single node (the local get-cache especially, but also a
# storage node whose replica placement diverged from another declarer's) can
# hold a partial subkey dictionary, and a first-fresh read would return that
# partial set: a freshly-declared replica stays invisible, or worse, a dead
# server's dangling single-entry dict masks the live replicas. The traversal
# merges every visited node's dictionary subkey-wise (_SearchResult
# .add_candidate), so the resolved ExpertInfo carries the union. Used by
# `get_experts` ONLY — explicit route-building, where the extra hops are off
# the serving hot path.
REPLICA_SET_SUFFICIENCY = float("inf")


def make_expert_record(peer_b58: str, compression: Optional[str] = None) -> str:
    """The stored declaration value; compression rides after a ``|``."""
    return f"{peer_b58}{_RECORD_DELIMITER}{compression}" if compression else peer_b58


def parse_expert_record(value) -> Optional[Tuple[PeerID, Optional[str]]]:
    """``(peer_id, compression_or_None)`` from a declaration value, or None if
    the value is malformed (DHT records are remote-supplied)."""
    if not isinstance(value, str):
        return None
    peer_b58, _, compression = value.partition(_RECORD_DELIMITER)
    try:
        return PeerID.from_base58(peer_b58), (compression or None)
    except Exception:
        return None


def parse_expert_replicas(entry_value) -> List[ReplicaInfo]:
    """The replica set from one leaf declaration value, deterministically
    ordered (sorted by peer id). Accepts every wire form: a legacy plain
    ``peer|codec`` string (one replica) or the subkey dictionary
    ``{peer_b58: ValueWithExpiration(record)}``. Malformed members are skipped
    — DHT records are remote-supplied."""
    records: List[ReplicaInfo] = []
    if isinstance(entry_value, dict):
        seen = set()
        for _subkey, stored in entry_value.items():
            value = getattr(stored, "value", stored)
            parsed = parse_expert_record(value)
            if parsed is None or parsed[0] in seen:
                continue
            seen.add(parsed[0])
            records.append(ReplicaInfo(*parsed))
        records.sort(key=lambda replica: replica.peer_id.to_base58())
    else:
        parsed = parse_expert_record(entry_value)
        if parsed is not None:
            records.append(ReplicaInfo(*parsed))
    return records


def expert_info_from_entry(uid: ExpertUID, entry_value) -> Optional[ExpertInfo]:
    """Build the resolved :class:`ExpertInfo` (primary = first replica in the
    deterministic order; clients re-select by scorecard latency / seeded rng —
    moe/client/expert.py) from a leaf declaration value, or None if empty or
    malformed."""
    replicas = parse_expert_replicas(entry_value)
    if not replicas:
        return None
    primary = replicas[0]
    return ExpertInfo(uid, primary.peer_id, primary.compression, tuple(replicas))


def declare_experts(
    dht: DHT,
    uids: Sequence[ExpertUID],
    expiration_time: Optional[DHTExpiration] = None,
    wait: bool = True,
    compression: Optional[str] = None,
):
    """Store this peer's experts: for 'ffn.5.12' store subkey 5 under 'ffn.' and
    subkey 12 under 'ffn.5.' plus the leaf record."""
    expiration_time = expiration_time if expiration_time is not None else get_dht_time() + 300
    peer_b58 = dht.peer_id.to_base58()
    record = make_expert_record(peer_b58, compression)

    async def _declare(dht_obj, node):
        keys, values, subkeys, expirations = [], [], [], []
        for uid in uids:
            assert is_valid_uid(uid), f"invalid expert uid {uid!r}"
            # leaf record under this peer's OWN subkey: concurrent
            # declarations from several replicas merge subkey-wise into one
            # replica set instead of clobbering each other newest-wins
            keys.append(uid)
            subkeys.append(peer_b58)
            values.append(record)
            expirations.append(expiration_time)
            prefix = uid
            while True:
                prefix, coord = split_uid(prefix)
                keys.append(prefix.rstrip(UID_DELIMITER))
                subkeys.append(coord)
                values.append(record)
                expirations.append(expiration_time)
                if UID_DELIMITER not in prefix.rstrip(UID_DELIMITER):
                    break  # reached the grid root (e.g. 'ffn_test')
        return await node.store_many(keys, values, expirations, subkeys=subkeys)

    result = dht.run_coroutine(_declare, return_future=not wait)
    return result


def get_experts(
    dht: DHT, uids: Sequence[ExpertUID], expiration_time: Optional[DHTExpiration] = None, wait: bool = True
):
    """Resolve expert UIDs to ExpertInfo(uid, peer_id, compression) (or None if
    not found)."""

    async def _get(dht_obj, node) -> List[Optional[ExpertInfo]]:
        found = await node.get_many(
            list(uids), sufficient_expiration_time=REPLICA_SET_SUFFICIENCY
        )
        out: List[Optional[ExpertInfo]] = []
        for uid in uids:
            entry = found.get(uid)
            out.append(expert_info_from_entry(uid, entry.value) if entry is not None else None)
        return out

    return dht.run_coroutine(_get, return_future=not wait)
