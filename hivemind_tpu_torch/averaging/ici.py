"""MeshAverager: a DecentralizedAverager whose averaged tensors live on a mesh (the port
of hivemind_tpu/averaging/ici.py) — the bridge between the swarm tier and the mesh tier.

One mesh = one logical swarm peer. Per round:

1. ``_pre_allreduce``: the mesh-resident tensors are staged to the host mirrors through
   :class:`~hivemind_tpu_torch.parallel.ici.MeshTensorBridge` (an optional mean over
   ``local_reduce_axis`` on the devices, then each region pulled once);
2. the inherited butterfly all-reduce averages the host mirrors with other swarm peers;
3. ``_post_allreduce``: the averaged mirrors go back onto the mesh, each rank taking its
   region, written into the tensors in place.

Staging is collective over the mesh's ranks. So the round's own hooks stage only on a
one-rank mesh; on a larger mesh every rank must join, and :class:`SliceAverager`
(``averaging/slice.py``) drives the staging at synchronized points
(``external_staging=True``, on the network rank, which alone holds this averager).

With ``local_reduce_axis``, each rank along that axis holds its own replica of every
tensor; the swarm contribution is their mean, and after the round every replica adopts
the swarm average."""

from __future__ import annotations

import asyncio
import threading
from typing import List, Optional, Sequence

import torch

from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.parallel.ici import MeshTensorBridge
from hivemind_tpu_torch.parallel.mesh import Mesh, NamedSharding
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

BASE_BANDWIDTH = 1.0e8  # a host's advertised egress, as a single-host peer advertises


class MeshAverager(DecentralizedAverager):
    """See module docstring.

    :param tensors: this rank's tensors (its shards, where ``shardings`` shard them),
        averaged with the swarm and updated in place
    :param mesh: the mesh they live on
    :param shardings: each tensor's sharding (default: replicated)
    :param local_reduce_axis: if set, each rank along this axis holds a replica; the
        peer's swarm contribution is their mean on the devices
    :param external_staging: the caller stages (collectively) instead of the round's hooks
    """

    def __init__(
        self,
        tensors: Sequence[torch.Tensor],
        mesh: Mesh,
        dht: DHT,
        *,
        shardings: Optional[Sequence[NamedSharding]] = None,
        local_reduce_axis: Optional[str] = None,
        external_staging: bool = False,
        **kwargs,
    ):
        if mesh.size > 1 and not external_staging:
            raise ValueError(f"staging on a mesh of {mesh.size} ranks is collective: every rank must join "
                             f"(use SliceAverager, which stages at synchronized points)")
        self.bridge = MeshTensorBridge(mesh)
        self.local_reduce_axis = local_reduce_axis
        self.external_staging = external_staging
        self._device_tensors: List[torch.Tensor] = list(tensors)
        self._shardings = shardings
        self._tensors_lock = threading.Lock()
        # one mesh = one logical peer: its advertised bandwidth to the load balancer is
        # the slice's AGGREGATE egress (a slice's swarm bandwidth scales with its hosts)
        if kwargs.get("bandwidth") is None:
            kwargs["bandwidth"] = BASE_BANDWIDTH * max(mesh.num_hosts, 1)
        host_tensors = self.bridge.gather_reduced_to_host(self._device_tensors, shardings, reduce_axis=local_reduce_axis)
        super().__init__(host_tensors, dht, **kwargs)

    @property
    def device_tensors(self) -> List[torch.Tensor]:
        with self._tensors_lock:
            return self._device_tensors

    def _stage_to_host(self) -> None:
        """Reduce (over ``local_reduce_axis``) and pull each leaf into the mirrors."""
        with self._tensors_lock, self.lock_averaged_tensors:
            self.bridge.stage_reduced_into_mirrors(self._device_tensors, self._averaged_tensors, self._shardings,
                                                   reduce_axis=self.local_reduce_axis)

    def _scatter_to_mesh(self) -> None:
        """The averaged mirrors back into the tensors, one leaf at a time."""
        with self._tensors_lock:
            with self.lock_averaged_tensors:
                mirrors = [mirror.copy() for mirror in self._averaged_tensors]
            adopted = self.bridge.scatter_from_host(self._device_tensors, mirrors, self._shardings)
            with torch.no_grad():
                for tensor, value in zip(self._device_tensors, adopted):
                    tensor.copy_(value)

    async def _pre_allreduce(self) -> None:
        if not self.external_staging:
            await asyncio.get_event_loop().run_in_executor(None, self._stage_to_host)

    async def _post_allreduce(self) -> None:
        if not self.external_staging:
            await asyncio.get_event_loop().run_in_executor(None, self._scatter_to_mesh)
