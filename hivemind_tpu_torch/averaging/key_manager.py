"""Group keys: where averagers advertise themselves for matchmaking
(the port of hivemind_tpu/averaging/key_manager.py; upstream: hivemind/averaging/key_manager.py).

Averagers looking for a group declare themselves as subkeys of ``{prefix}.0b{bits}``.
After every successful round the group id seeds an RNG that scatters the members into
fresh buckets, so information mixes across the whole swarm over successive rounds
(upstream key_manager.py:94-105; the "Moshpit SGD" rebucketing)."""

from __future__ import annotations

import random
import re
from typing import List, Optional, Tuple

from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.p2p import PeerID
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, get_dht_time

logger = get_logger(__name__)

GroupKey = str
GROUP_PATTERN = re.compile(r"^(([^.])+)[.]0b[01]*$")


def is_valid_group(maybe_group: str) -> bool:
    return bool(GROUP_PATTERN.fullmatch(maybe_group))


class GroupKeyManager:
    def __init__(self, dht: DHT, prefix: str, initial_group_bits: str = "", target_group_size: Optional[int] = None):
        assert all(bit in "01" for bit in initial_group_bits)
        self.dht, self.prefix = dht, prefix
        self.group_bits = initial_group_bits
        self.target_group_size = target_group_size
        self.peer_id = dht.peer_id

    @property
    def current_key(self) -> GroupKey:
        return f"{self.prefix}.0b{self.group_bits}"

    async def declare_averager(
        self, group_key: GroupKey, peer_id: PeerID, expiration_time: DHTExpiration, looking_for_group: bool = True
    ) -> bool:
        """Advertise (or retract) an averager under the group key
        (upstream key_manager.py:46-68)."""
        expiration = expiration_time if looking_for_group else get_dht_time() + 1
        return await self.dht.node.store(
            key=group_key,
            subkey=peer_id.to_base58(),
            value=looking_for_group,
            expiration_time=expiration,
        )

    async def get_averagers(self, group_key: GroupKey, only_active: bool = True) -> List[Tuple[PeerID, DHTExpiration]]:
        """All averagers currently declared under the key
        (upstream key_manager.py:70-92)."""
        result = await self.dht.node.get(group_key, latest=True)
        if result is None or not isinstance(result.value, dict):
            return []
        averagers = []
        for subkey, entry in result.value.items():
            try:
                if only_active and entry.value is not True:
                    continue
                averagers.append((PeerID.from_base58(subkey), entry.expiration_time))
            except Exception as e:
                logger.debug(f"malformed averager record {subkey!r}: {e!r}")
        return averagers

    async def update_key_on_group_assembled(self, group_info: GroupInfo) -> None:
        """Deterministic rebucketing: every member derives a distinct pseudo-random
        bucket from the shared group id, so groups mix across rounds."""
        nbits = len(self.group_bits)
        if nbits == 0:
            return
        rng = random.Random(group_info.group_id)
        num_buckets = 2**nbits
        assignments = [rng.randrange(num_buckets) for _ in range(group_info.group_size)]
        index = group_info.peer_ids.index(self.peer_id)
        self.group_bits = format(assignments[index], f"0{nbits}b")
        logger.debug(f"rebucketed to group bits {self.group_bits}")

    async def update_key_on_not_enough_peers(self) -> None:
        """Failed to assemble: drop one bit so the bucket is larger next time
        (upstream behavior on starvation)."""
        if self.group_bits:
            self.group_bits = self.group_bits[:-1]
            logger.debug(f"too few peers; widened bucket to {self.group_bits!r}")
