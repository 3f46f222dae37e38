"""The device↔host boundary of a mesh that acts as ONE swarm peer (the port of
hivemind_tpu/parallel/ici.py).

Per-replica values are reduced on the devices (``mesh_mean``: an ``all_reduce`` over one
mesh axis), then every leaf is assembled on rank 0's host: each distinct region is
pulled from exactly one rank, one leaf at a time, and written into a preallocated host
mirror. So no rank holds a second model copy: the followers hold no mirror at all, and
rank 0 holds the mirrors plus one region in flight. After the swarm round, the averaged
mirrors go back the other way one leaf at a time, each rank receiving only its region.

Every method here is COLLECTIVE: each rank of the mesh calls it with its own local
tensors, in the same order. The mirrors are float32 arrays in the layout the shardings
describe (the flax layout: a ``transposed`` leaf's mirror is the transpose of its torch
tensor), on rank 0; the other ranks pass and get ``None``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hivemind_tpu_torch.parallel.mesh import Mesh, NamedSharding, replicated

NETWORK_RANK = 0  # the rank whose host holds the mirrors


class MeshTensorBridge:
    """Device↔host staging for one mesh-resident logical peer.

    :param mesh: the mesh; ``shardings`` arguments default to replicated leaves"""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def is_network_rank(self) -> bool:
        return self.mesh.rank == NETWORK_RANK

    def _shardings(self, leaves: Sequence[torch.Tensor], shardings: Optional[Sequence[NamedSharding]]):
        shardings = [replicated(self.mesh)] * len(leaves) if shardings is None else list(shardings)
        if len(shardings) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves but {len(shardings)} shardings")
        return shardings

    # ---------------------------------------------------------------- on-device reduce

    def mesh_mean(self, leaves: Sequence[torch.Tensor], axis: str = "dp") -> List[torch.Tensor]:
        """The mean over ``axis`` of each rank's own value of every leaf (each rank along
        the axis holds one replica), computed on the devices: new tensors, equal on every
        rank of the axis. The JAX package's ``pmean`` under ``shard_map``."""
        return [self._reduce_leaf(leaf, axis, "mean") for leaf in leaves]

    def _reduce_leaf(self, leaf: torch.Tensor, axes, op: str) -> torch.Tensor:
        reduced = leaf.detach().to(torch.float32, copy=True)
        self.mesh.all_reduce(reduced, axes)
        if op == "mean":
            count = int(np.prod([self.mesh.shape[a] for a in ((axes,) if isinstance(axes, str) else axes)]))
            reduced /= count
        return reduced

    def stage_reduced_into_mirrors(self, leaves: Sequence[torch.Tensor], mirrors: Optional[Sequence[np.ndarray]],
                                   shardings: Optional[Sequence[NamedSharding]] = None,
                                   reduce_axis=None, op: str = "mean") -> None:
        """STREAMING stage: reduce each leaf over ``reduce_axis`` (an axis or a tuple of
        them; ``op`` ``"mean"`` or ``"sum"``) and assemble it into rank 0's mirror, one
        leaf at a time, freeing the reduced transient before the next leaf."""
        shardings = self._shardings(leaves, shardings)
        for index, (leaf, sharding) in enumerate(zip(leaves, shardings)):
            reduced = self._reduce_leaf(leaf, reduce_axis, op) if reduce_axis is not None else leaf
            self._stage_leaf(reduced, None if mirrors is None else mirrors[index], sharding)
            del reduced

    # ---------------------------------------------------------------- host boundary

    def _stage_leaf(self, leaf: torch.Tensor, mirror: Optional[np.ndarray], sharding: NamedSharding) -> None:
        """Pull each distinct region of ``leaf`` from the one rank that owns it into rank
        0's ``mirror`` (region by region, over point-to-point messages)."""
        local = sharding.flax_view(leaf.detach())
        full_shape = sharding.global_shape(local.shape)
        for owner, region in sharding.owners(full_shape):
            if owner == self.mesh.rank == NETWORK_RANK:
                mirror.reshape(full_shape)[region] = local.to("cpu", torch.float32).numpy()
            elif self.mesh.rank == NETWORK_RANK:
                incoming = torch.empty(local.shape, dtype=torch.float32,
                                       device="cpu" if self.mesh.backend == "gloo" else self.mesh.device)
                dist.recv(incoming, src=owner)
                mirror.reshape(full_shape)[region] = incoming.cpu().numpy()
            elif self.mesh.rank == owner:
                outgoing = local.to(torch.float32).contiguous()
                dist.send(outgoing.cpu() if self.mesh.backend == "gloo" else outgoing, dst=NETWORK_RANK)

    def stage_into_mirrors(self, leaves: Sequence[torch.Tensor], mirrors: Optional[Sequence[np.ndarray]],
                           shardings: Optional[Sequence[NamedSharding]] = None) -> None:
        """Assemble every leaf into rank 0's preallocated mirror, region by region: no
        rank gathers a whole replica, and rank 0's host holds the mirrors plus one region."""
        self.stage_reduced_into_mirrors(leaves, mirrors, shardings, reduce_axis=None)

    def allocate_mirrors(self, leaves: Sequence[torch.Tensor], shardings: Optional[Sequence[NamedSharding]] = None
                         ) -> Optional[List[np.ndarray]]:
        """Fresh float32 mirrors of the whole leaves on rank 0; None on the other ranks."""
        if not self.is_network_rank:
            return None
        return [np.empty(sharding.global_shape(sharding.flax_view(leaf).shape), np.float32)
                for leaf, sharding in zip(leaves, self._shardings(leaves, shardings))]

    def gather_reduced_to_host(self, leaves: Sequence[torch.Tensor], shardings: Optional[Sequence[NamedSharding]] = None,
                               reduce_axis=None, op: str = "mean") -> Optional[List[np.ndarray]]:
        """``gather_to_host`` of the leaves reduced over ``reduce_axis``, one leaf in flight."""
        mirrors = self.allocate_mirrors(leaves, shardings)
        self.stage_reduced_into_mirrors(leaves, mirrors, shardings, reduce_axis, op)
        return mirrors

    def gather_to_host(self, leaves: Sequence[torch.Tensor], shardings: Optional[Sequence[NamedSharding]] = None
                       ) -> Optional[List[np.ndarray]]:
        """Whole float32 host copies of every leaf on rank 0 (None elsewhere)."""
        return self.gather_reduced_to_host(leaves, shardings, reduce_axis=None)

    def scatter_leaf(self, like_leaf: torch.Tensor, host_value: Optional[np.ndarray],
                     sharding: Optional[NamedSharding] = None) -> torch.Tensor:
        """Rank 0's whole ``host_value`` back onto the mesh: each rank receives its region
        as a new tensor of ``like_leaf``'s shape, dtype and device (a replicated leaf is
        one broadcast; a sharded leaf one scatter)."""
        sharding = sharding if sharding is not None else replicated(self.mesh)
        local_shape = tuple(sharding.flax_view(like_leaf).shape)
        full_shape = sharding.global_shape(local_shape)
        wire_device = torch.device("cpu") if self.mesh.backend == "gloo" else self.mesh.device
        received = torch.empty(local_shape, dtype=torch.float32, device=wire_device)
        if self.is_network_rank:
            value = np.asarray(host_value, dtype=np.float32).reshape(full_shape)
        if sharding.is_replicated:
            if self.is_network_rank:
                received.copy_(torch.from_numpy(value))
            if self.mesh.size > 1:
                dist.broadcast(received, src=NETWORK_RANK)
        else:
            regions = None
            if self.is_network_rank:
                coordinates = [dict(zip(("dp", "tp", "sp"), np.unravel_index(rank, tuple(self.mesh.shape.values()))))
                               for rank in range(self.mesh.size)]
                regions = [torch.from_numpy(np.ascontiguousarray(value[sharding.region(full_shape, c)])).to(wire_device)
                           for c in coordinates]
            dist.scatter(received, regions, src=NETWORK_RANK)
        local = received.T if sharding.transposed else received
        return local.to(like_leaf.device, like_leaf.dtype).contiguous()

    def scatter_from_host(self, like_leaves: Sequence[torch.Tensor], host_tensors: Optional[Sequence[np.ndarray]],
                          shardings: Optional[Sequence[NamedSharding]] = None) -> List[torch.Tensor]:
        """``scatter_leaf`` of every leaf, in order."""
        shardings = self._shardings(like_leaves, shardings)
        return [self.scatter_leaf(leaf, None if host_tensors is None else host_tensors[i], sharding)
                for i, (leaf, sharding) in enumerate(zip(like_leaves, shardings))]

    def broadcast_scatter_from_host(self, like_leaves: Sequence[torch.Tensor], host_tensors: Optional[Sequence[np.ndarray]],
                                    shardings: Optional[Sequence[NamedSharding]] = None, axis: str = "dp") -> List[torch.Tensor]:
        """Reduced host values back to per-replica leaves: every replica along ``axis``
        adopts the (swarm-averaged) value. Each rank holds its replica, so this is
        ``scatter_from_host``: the ranks along ``axis`` receive the same region."""
        del axis
        return self.scatter_from_host(like_leaves, host_tensors, shardings)

    def broadcast_array(self, value: Optional[np.ndarray], shape, device: Optional[torch.device] = None) -> torch.Tensor:
        """Rank 0's float32 ``value`` of ``shape`` on every rank, as a tensor on ``device``
        (the rank's device by default): the JAX package's ``broadcast_one_to_all``."""
        wire_device = torch.device("cpu") if self.mesh.backend == "gloo" else self.mesh.device
        tensor = torch.empty(tuple(shape), dtype=torch.float32, device=wire_device)
        if self.is_network_rank:
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32).reshape(tuple(shape))))
        if self.mesh.size > 1:
            dist.broadcast(tensor, src=NETWORK_RANK)
        return tensor.to(device if device is not None else self.mesh.device)
