"""Assembled group descriptor (the port of hivemind_tpu/averaging/group_info.py; upstream: hivemind/averaging/group_info.py)."""

from __future__ import annotations

from typing import NamedTuple, Tuple

from hivemind_tpu_torch.p2p import PeerID


class GroupInfo(NamedTuple):
    group_id: bytes  # random unique id assigned by the leader
    peer_ids: Tuple[PeerID, ...]  # group members in leader-shuffled order
    gathered: Tuple[bytes, ...]  # opaque per-peer metadata blobs, same order

    @property
    def group_size(self) -> int:
        return len(self.peer_ids)

    def __contains__(self, peer_id: PeerID) -> bool:
        return peer_id in self.peer_ids
