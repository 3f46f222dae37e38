"""A ``(dp, tp, sp)`` mesh of ``torch.distributed`` ranks and the sharding rules of the
transformer parameters (the port of hivemind_tpu/parallel/mesh.py).

Axes: ``dp`` (data), ``tp`` (tensor/model), ``sp`` (sequence/context). Each rank is one
process; rank ``r`` sits at coordinate ``(r // (tp·sp), (r // sp) % tp, r % sp)``, the
order of the JAX package's ``np.array(devices).reshape(dp, tp, sp)``.

The backend is the caller's choice, never a fallback: ``nccl`` where each rank owns a
card, ``gloo`` where ranks share a card or run on the CPU. Over gloo every collective
moves host tensors, so ranks whose tensors lie on a card stage them through pinned host
buffers (:attr:`Mesh.stages_through_host`); over nccl the card's tensors move as they are.

A sharding is a spec over the parameter's FLAX layout (the JAX package's
``PartitionSpec``, here a tuple of axis names or None per dimension), matched against the
``/``-joined flax path of ``convert.flax_path``; a Dense weight is the transpose of its
flax kernel, so its spec reads reversed on the torch tensor."""

from __future__ import annotations

import dataclasses
import os
import re
import socket
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from hivemind_tpu_torch.convert import flax_path
from hivemind_tpu_torch.utils.device import resolve_device

AXES = ("dp", "tp", "sp")
BACKENDS = ("nccl", "gloo")
PartitionSpec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> PartitionSpec:
    """A partition spec: one mesh axis name (or None) per dimension, as ``jax.sharding.P``."""
    return tuple(axes)


class Mesh:
    """The ranks of one job as a ``(dp, tp, sp)`` grid (build it with :func:`make_mesh`).

    ``shape`` maps each axis to its size, ``coordinate`` this rank's position, ``device``
    the rank's compute device. The collectives below run over the ranks that share this
    rank's coordinates on every axis but the named ones, and take tensors on ``device``."""

    def __init__(self, device_mesh, backend: str, device: torch.device, num_hosts: int):
        self.device_mesh = device_mesh
        self.backend, self.device, self.num_hosts = backend, device, num_hosts
        self.shape: Dict[str, int] = dict(zip(AXES, device_mesh.shape))
        self.coordinate: Dict[str, int] = dict(zip(AXES, device_mesh.get_coordinate()))
        self.rank, self.size = dist.get_rank(), dist.get_world_size()
        self._host_buffers: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, sp={self.shape['sp']}, backend={self.backend!r}, device={self.device})"

    # ------------------------------------------------------------------ layout

    def rank_of(self, **coordinate: int) -> int:
        """The global rank at ``coordinate`` (axes left out are this rank's)."""
        c = {**self.coordinate, **coordinate}
        return (c["dp"] * self.shape["tp"] + c["tp"]) * self.shape["sp"] + c["sp"]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in coordinate order."""
        return [self.rank_of(**{axis: i}) for i in range(self.shape[axis])]

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def stages_through_host(self) -> bool:
        """Whether collectives copy the card's tensors through pinned host buffers (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # ------------------------------------------------------------------ transport

    def _host_buffer(self, slot: str, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, kept by (slot, dtype) and grown."""
        key = (slot, like.dtype)
        buffer = self._host_buffers.get(key)
        if buffer is None or buffer.numel() < like.numel():
            buffer = self._host_buffers[key] = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
        return buffer[:like.numel()].view(like.shape)

    def _wire(self, tensor: torch.Tensor, slot: str) -> torch.Tensor:
        """The tensor a collective moves: itself, or (gloo with a card) a pinned host
        buffer of ``slot`` holding a copy."""
        if self.backend == "nccl" or tensor.device.type == "cpu":
            return tensor
        return self._host_buffer(slot, tensor).copy_(tensor)

    def all_reduce(self, tensor: torch.Tensor, axes: Union[str, Sequence[str]], op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``tensor`` in place over each of ``axes`` (skipping axes of size 1)."""
        for axis in (axes,) if isinstance(axes, str) else axes:
            if self.shape[axis] == 1:
                continue
            wire = self._wire(tensor, "reduce")
            dist.all_reduce(wire, op=op, group=self.group(axis))
            if wire is not tensor:
                tensor.copy_(wire)
        return tensor

    def all_gather(self, tensor: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``tensor`` along ``axis``, in coordinate order, on this rank's device."""
        if self.shape[axis] == 1:
            return [tensor]
        wire = self._wire(tensor.contiguous(), "gather")
        parts = [torch.empty_like(wire) for _ in range(self.shape[axis])]
        dist.all_gather(parts, wire, group=self.group(axis))
        return [part.to(tensor.device) for part in parts]

    def ring_shift(self, tensors: Sequence[torch.Tensor], axis: str, direction: int = 1) -> List[torch.Tensor]:
        """Send ``tensors`` to the next rank along ``axis`` (``direction`` +1; the previous
        one for -1) and return what the rank on the other side sent: one message of the
        tensors packed together (they share a dtype). The JAX package's ``ppermute`` by
        ``(i, i + direction)``."""
        size = self.shape[axis]
        if size == 1:
            return list(tensors)
        ranks = self.axis_ranks(axis)
        here = self.coordinate[axis]
        destination, source = ranks[(here + direction) % size], ranks[(here - direction) % size]
        packed = torch.cat([t.reshape(-1) for t in tensors])
        outgoing = self._wire(packed, "send")
        incoming = torch.empty_like(outgoing) if outgoing is packed else self._host_buffer("recv", packed)
        requests = dist.batch_isend_irecv([dist.P2POp(dist.isend, outgoing, destination, group=self.group(axis)),
                                           dist.P2POp(dist.irecv, incoming, source, group=self.group(axis))])
        for request in requests:
            request.wait()
        received = incoming.to(packed.device) if incoming.device != packed.device else incoming
        parts, offset = [], 0
        for t in tensors:
            parts.append(received[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        return parts


def make_mesh(
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    *,
    backend: str,
    device: Union[str, torch.device] = "cuda",
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Mesh:
    """A ``(dp, tp, sp)`` mesh over every rank of the job (``torch.distributed``'s
    ``init_device_mesh``), initializing the default process group from ``init_method``
    (e.g. ``tcp://localhost:29500``), ``rank`` and ``world_size`` when it is not yet up.

    :param backend: ``"nccl"`` (each rank owns a card) or ``"gloo"`` (ranks share a card
        or run on the CPU); must be the default group's backend
    :param device: ``cuda`` (the rank's card: ``LOCAL_RANK``, else its rank modulo the
        cards, round-robin over gloo) or ``cpu``; nothing moves a rank to the CPU
    """
    from torch.distributed.device_mesh import init_device_mesh

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    device = resolve_device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend moves card tensors; a CPU mesh runs over gloo")
    if not dist.is_initialized():
        if init_method is None or rank is None or world_size is None:
            raise ValueError("no default process group: pass init_method, rank and world_size")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs {dist.get_backend()!r}, the mesh asks for {backend!r}")
    needed = dp * tp * sp
    if dist.get_world_size() != needed:
        raise ValueError(f"a ({dp}, {tp}, {sp}) mesh needs {needed} ranks, the job has {dist.get_world_size()}")
    if device.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    places: List[Tuple[str, str]] = [None] * needed  # type: ignore[list-item]
    dist.all_gather_object(places, (socket.gethostname(), str(device)))
    if backend == "nccl" and len(set(places)) < needed:
        raise ValueError(f"nccl needs a card for each rank, and ranks share one ({places}); ranks sharing a card use gloo")
    device_mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (dp, tp, sp), mesh_dim_names=AXES)
    return Mesh(device_mesh, backend, device, num_hosts=len({host for host, _ in places}))


# sharding rules for transformer parameters, matched against '/'-joined flax paths.
# TP shards attention heads and the ffn intermediate dimension; everything else is
# replicated (embeddings stay replicated: ALBERT's factorized embedding is small).
_PARAM_RULES = [
    (r".*(query|key|value)/kernel$", P(None, "tp")),
    (r".*(query|key|value)/bias$", P("tp")),
    (r".*attention_out/kernel$", P("tp", None)),
    (r".*attention_out/bias$", P()),
    (r".*ffn_up/kernel$", P(None, "tp")),
    (r".*ffn_up/bias$", P("tp")),
    (r".*ffn_down/kernel$", P("tp", None)),
    (r".*ffn_down/bias$", P()),
]


def param_spec(path: str, value=None) -> PartitionSpec:
    """The spec of the parameter at flax ``path`` (``shared_layer/query/kernel``)."""
    for pattern, spec in _PARAM_RULES:
        if re.fullmatch(pattern, path):
            return spec
    return P()  # replicated


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` over the flax layout of a tensor whose torch layout is its transpose when
    ``transposed`` (a Dense weight). Regions and shards are read on the flax layout."""

    mesh: Optional[Mesh]
    spec: PartitionSpec
    transposed: bool = False

    def axes(self, ndim: int) -> PartitionSpec:
        """The spec padded to ``ndim`` dimensions (an unnamed dimension is not split)."""
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    @property
    def is_replicated(self) -> bool:
        return all(axis is None or self.mesh.shape[axis] == 1 for axis in self.spec)

    def flax_view(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` (torch layout) as a view in the flax layout."""
        return tensor.T if self.transposed else tensor

    def global_shape(self, local_flax_shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole tensor's flax shape from a shard's."""
        spec = self.axes(len(local_flax_shape))
        return tuple(n * (self.mesh.shape[a] if a else 1) for n, a in zip(local_flax_shape, spec))

    def region(self, flax_shape: Sequence[int], coordinate: Mapping[str, int]) -> Tuple[slice, ...]:
        """The slices of the whole (flax-layout) tensor held at ``coordinate``."""
        slices = []
        for n, axis in zip(flax_shape, self.axes(len(flax_shape))):
            if axis is None or self.mesh.shape[axis] == 1:
                slices.append(slice(None))
                continue
            parts = self.mesh.shape[axis]
            if n % parts:
                raise ValueError(f"a dimension of {n} does not split over {parts} {axis} ranks")
            step = n // parts
            slices.append(slice(coordinate[axis] * step, (coordinate[axis] + 1) * step))
        return tuple(slices)

    def owners(self, flax_shape: Sequence[int]) -> List[Tuple[int, Tuple[slice, ...]]]:
        """``(global rank, region)`` of each distinct region, each read from one rank:
        the rank at coordinate 0 on every axis the spec does not shard."""
        sharded = [a for a in self.axes(len(flax_shape)) if a is not None and self.mesh.shape[a] > 1]
        coordinates = [{}]
        for axis in sharded:
            coordinates = [{**c, axis: i} for c in coordinates for i in range(self.mesh.shape[axis])]
        zero = {axis: 0 for axis in AXES}
        return [(self.mesh.rank_of(**{**zero, **c}), self.region(flax_shape, {**zero, **c})) for c in coordinates]

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (torch layout), as a view."""
        flax = self.flax_view(full)
        block = flax[self.region(flax.shape, self.mesh.coordinate)]
        return block.T if self.transposed else block


def params_shardings(params: Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]],
                     mesh: Mesh) -> Dict[str, NamedSharding]:
    """The sharding of each parameter (keyed like ``named_parameters()``), by matching
    the rules above against its flax path."""
    shardings = {}
    for name, value in dict(params).items():
        path, transposed = flax_path(name, value.ndim)
        shardings[name] = NamedSharding(mesh, param_spec("/".join(path), value), transposed)
    return shardings


def batch_sharding(mesh: Mesh, seq_sharded: bool = True) -> NamedSharding:
    """Input batch [batch, seq]: batch over dp, sequence over sp (context parallel)."""
    return NamedSharding(mesh, P("dp", "sp" if seq_sharded else None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Whole parameters (a ``state_dict`` of the unsharded model) as this rank's blocks
    (copies), for the mesh model's ``load_state_dict``."""
    shardings = params_shardings(state, mesh)
    return {name: shardings[name].shard(value).contiguous().clone() for name, value in state.items()}


def shard_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh, seq_sharded: bool = True) -> Dict[str, torch.Tensor]:
    """This rank's ``[dp, sp]`` block of a global ``[batch, seq]`` batch, on the rank's
    device (the counterpart of ``jax.device_put(batch, batch_sharding(mesh))``)."""
    sharding = batch_sharding(mesh, seq_sharded)
    return {key: value[sharding.region(value.shape, mesh.coordinate)].to(mesh.device) for key, value in batch.items()}


class _ReduceFrom(torch.autograd.Function):
    """The sum over mesh axes in the forward, the identity in the backward: every rank
    of those axes holds the same total, and the gradient reaching it is the gradient of
    each rank's own term (Megatron's ``g``; the loss's sum over the data axes)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.clone(), axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _CopyTo(torch.autograd.Function):
    """The identity in the forward, the sum over mesh axes in the backward: the input
    of a layer whose ranks each compute a part of the output (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.clone(), ctx.axes), None, None


def reduce_from(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _CopyTo.apply(x, mesh, axes)
