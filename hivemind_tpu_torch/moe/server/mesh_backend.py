"""Tensor-parallel block serving over a serving mesh (the port of
hivemind_tpu/moe/server/mesh_backend.py): the serving unit is a list of devices,
not one card.

The JAX package lets GSPMD shard a block's parameters and KV caches over a device
mesh inside one process (``run_server --mesh_devices`` takes the first N local
devices). The port keeps that shape: a :class:`ServingMesh` is an explicit list of
``torch.device``s held by the one process that runs the Runtime, and a
:class:`MeshModuleBackend` serves one Llama block over it, Megatron style. Shard r
holds:

- heads ``[r·H/N, (r+1)·H/N)`` of ``query`` and the matching KV heads of ``key``
  and ``value`` (column parallel: output features);
- the matching input columns of ``attention_out`` (row parallel);
- ``inner/N`` of ``ffn_gate`` and ``ffn_up``, and the matching input columns of
  ``ffn_down``;
- a copy of both RMSNorm weights.

Each shard computes its partial on its own device with the block's own functions
(``layers/common.py``: ``rms_norm``, ``dense``, ``apply_rope``, ``attention_auto``,
``_decode_attention``). The partials of ``attention_out`` and ``ffn_down`` come
out of each shard's GEMM in bf16, as the block's Dense output does; they are
summed in fp32 on ``devices[0]``, the sum is rounded once to bf16, added to the
fp32 residual stream, and that stream goes to every shard for the next stage.
Work for distinct cards is queued without a sync, so those cards run
concurrently; N shards on one card run one after another. The rest of the
serving stack (``Server``, ``ConnectionHandler``, task pools, decode sessions,
``RemoteSequential``) is unchanged: a client cannot tell a mesh from one card.

Int8 serving: each leaf is quantized whole by the blockwise kernel (bit for bit
the JAX package's codes and absmax), and each shard keeps its rows or columns of
the codes with the whole absmax (``ops/quantized_params.py::QuantizedWindow``).
KV caches are split over the kv-heads axis (``shard_decode_cache``): a decode
session holds one cache a shard, on the shard's device.

Training: ``backward`` runs the same shard-by-shard forward under autograd, which
carries the gradients back through the cross-device copies of the broadcast and of
the fp32 reduce (so each shard's attention runs the flash backward kernels on its own
card), then applies one step of the backend's optimizer, built over every shard's
tensors. A norm weight has a copy on every shard: its gradient is the sum of the
shards', computed once on the first device and given to every copy, so the copies
take the same step and stay identical. ``state_dict`` assembles the optimizer's
statistics from the shards in the single-device optax layout, and
``load_state_dict`` cuts them back. An int8 mesh refuses the backward, as an int8
single-device backend does.

Not ported: the JAX mesh serves any block and any N (GSPMD resolves every
placement); this one serves ``llama_block`` with ``num_kv_heads % N == 0``
(ROADMAP: the serving mesh's follow-ups).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hivemind_tpu_torch.convert import from_flax_albert_params, to_flax_tree
from hivemind_tpu_torch.moe.server.layers import init_parameters
from hivemind_tpu_torch.moe.server.layers.common import _decode_attention, apply_rope, dense, rms_norm
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend, load_optax_state, optax_state
from hivemind_tpu_torch.ops.flash_attention import attention_auto
from hivemind_tpu_torch.ops.quantized_params import QuantizedTensor, QuantizedWindow, cut_window, quantize_params
from hivemind_tpu_torch.utils import flax_msgpack
from hivemind_tpu_torch.utils.device import resolve_device

# how each leaf of a Llama block splits: along dim 0 of the nn.Linear weight [out, in]
# (output features: column parallel), along dim 1 (input features: row parallel), or
# not at all (a copy on every shard)
_SPLIT = {
    "query.weight": 0, "key.weight": 0, "value.weight": 0, "ffn_gate.weight": 0, "ffn_up.weight": 0,
    "attention_out.weight": 1, "ffn_down.weight": 1,
    "attention_norm.weight": None, "ffn_norm.weight": None,
}
_ATTENTION = ("attention_norm.weight", "query.weight", "key.weight", "value.weight", "attention_out.weight")
_FFN = ("ffn_norm.weight", "ffn_gate.weight", "ffn_up.weight", "ffn_down.weight")

Shard = Dict[str, Union[torch.Tensor, QuantizedWindow]]


class ServingMesh:
    """Devices that serve one block together, under the one axis ``"tp"``. ``shape``
    maps the axis to its size, as JAX's ``Mesh.shape`` does. A device may appear
    more than once (N shards on one card, or on the CPU in tests)."""

    axis_name = "tp"

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        self.devices = tuple(resolve_device(device) for device in devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: len(self.devices)}

    def __repr__(self):
        return f"ServingMesh({[str(device) for device in self.devices]})"


def local_cards(count: int) -> ServingMesh:
    """A mesh of the first ``count`` local cards, one shard a card (``run_server
    --mesh_devices``); raises as the JAX package does when there are fewer."""
    if count < 1:
        raise ValueError(f"--mesh_devices must be >= 1, got {count}")
    available = torch.cuda.device_count()
    if available < count:
        raise RuntimeError(f"--mesh_devices {count} but only {available} local devices")
    return ServingMesh([torch.device("cuda", index) for index in range(count)])


class MeshModuleBackend(ModuleBackend):
    """A :class:`ModuleBackend` whose Llama block is served tensor-parallel over a
    :class:`ServingMesh` (see module docstring). ``params``, when given, is a host
    (or any device's) dict of the block's weights: each leaf goes straight to its
    shards. ``self.params`` is the list of the shards' parameter dicts.

    :param mesh: the serving mesh; its first device takes the inputs and returns the outputs
    :param shard_axis: the mesh axis the block is split over
    """

    def __init__(self, name: str, module: nn.Module, *, mesh: ServingMesh, shard_axis: str = "tp", **kwargs):
        if shard_axis not in mesh.shape:
            raise ValueError(f"the mesh has no axis {shard_axis!r}: {mesh.shape}")
        self.mesh, self.shard_axis = mesh, shard_axis
        self.devices = mesh.devices
        kwargs["device"] = mesh.devices[0]
        super().__init__(name, module, **kwargs)

    def _init_state(self, module: nn.Module, params: Optional[Dict[str, torch.Tensor]], rng_seed: int,
                    sample_inputs: Sequence[np.ndarray]) -> tuple:
        parts = self._axis_size()
        names = {key for key, _ in module.named_parameters()}
        if names != set(_SPLIT):
            raise TypeError(f"MeshModuleBackend serves llama_block modules; {type(module).__name__} has {sorted(names)}")
        if module.num_kv_heads % parts:
            raise ValueError(f"expert {self.name!r}: num_kv_heads={module.num_kv_heads} is not a multiple of the "
                             f"mesh's {parts} shards (num_kv_heads % N == 0 is required)")
        inner = module.ffn_gate.weight.shape[0]
        if inner % parts:
            raise ValueError(f"expert {self.name!r}: the ffn width {inner} is not a multiple of {parts} shards")
        if params is None:  # a seeded init on the host; each leaf then goes to its shards
            module = module.to_empty(device="cpu")
            init_parameters(module, torch.Generator().manual_seed(rng_seed))
            params = {key: tensor.detach() for key, tensor in module.state_dict().items()}
        self.module = module.to("meta").eval().requires_grad_(False)
        self._shapes = {key: tuple(tensor.shape) for key, tensor in self.module.state_dict().items()}
        self.load_params(params)
        with torch.inference_mode():
            return (self._apply(self._to_device(sample_inputs[0][:1])),)

    # ------------------------------------------------------------------ shardings

    def _axis_size(self) -> int:
        return int(self.mesh.shape[self.shard_axis])

    def leaf_spec(self, leaf) -> Tuple[Optional[str], ...]:
        """The JAX package's accounting rule, as a partition spec tuple: a leaf of
        ndim >= 2 shards over its last axis when that divides the mesh; anything else
        replicates (``()``). The port's own split is ``_SPLIT``'s."""
        shape = tuple(getattr(leaf, "shape", ()))
        size = self._axis_size()
        if len(shape) >= 2 and shape[-1] % size == 0 and shape[-1] >= size:
            return (None,) * (len(shape) - 1) + (self.shard_axis,)
        return ()

    def _split_leaf(self, key: str, tensor: torch.Tensor) -> List[Union[torch.Tensor, QuantizedWindow]]:
        """One leaf as its shards, each on its device. An int8 leaf is quantized whole
        on ``devices[0]`` (the one leaf that is transient there) and cut."""
        dim, parts = _SPLIT[key], self._axis_size()
        if self.weight_quantization:
            whole = quantize_params({key: tensor.to(self.devices[0], torch.float32)})[key]
            if isinstance(whole, QuantizedTensor):
                return [cut_window(whole, dim, r, parts, device) for r, device in enumerate(self.devices)]
        pieces = [tensor] * parts if dim is None else tensor.chunk(parts, dim)
        return [piece.to(device, torch.float32, copy=True).contiguous() for piece, device in zip(pieces, self.devices)]

    def shard_decode_cache(self, cache_k: torch.Tensor, cache_v: torch.Tensor) -> Tuple[List[torch.Tensor], ...]:
        """A session's caches ``[batch, max_len, kv_heads, head_dim]`` as one tensor a
        shard, each holding the shard's kv heads on its device. Meta tensors (shapes
        only) become zeros on each device."""
        parts = self._axis_size()

        def split(cache: torch.Tensor) -> List[torch.Tensor]:
            pieces = cache.chunk(parts, dim=-2)
            return [torch.zeros(piece.shape, dtype=piece.dtype, device=device) if piece.is_meta
                    else piece.to(device, copy=True).contiguous() for piece, device in zip(pieces, self.devices)]

        return split(cache_k), split(cache_v)

    def init_decode_cache(self, batch: int, max_len: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """A decode session's fresh caches, one a shard: the shapes only, then each
        shard's zeros on its own device (no whole cache on any one device)."""
        return self.shard_decode_cache(*self.module.init_decode_cache(batch, max_len, "meta"))

    def decode_step(self, x: torch.Tensor, cache_k: List[torch.Tensor], cache_v: List[torch.Tensor], index):
        return self._apply(x, cache_k, cache_v, index)

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Replace the block's weights: each leaf lands straight on its shards (int8:
        quantized whole on the first device, then cut); a trainable mesh restarts its
        optimizer over the new shards."""
        self._check_params(params)
        shards: List[Shard] = [{} for _ in self.devices]
        for key, tensor in params.items():
            for shard, piece in zip(shards, self._split_leaf(key, torch.as_tensor(tensor))):
                shard[key] = piece
        optimizer = None if self.weight_quantization else self._make_optimizer(
            [tensor for shard in shards for tensor in shard.values()])
        with self._state_lock:
            self.params, self.optimizer = shards, optimizer

    # ------------------------------------------------------------------ execution

    def _broadcast(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every shard's device. Every copy is queued before any shard's work: a
        copy between cards runs on the first card's stream, behind whatever is queued
        there, so a copy queued after shard 0's work would hold the other cards idle."""
        return [x.to(device, non_blocking=True) for device in self.devices]

    def _reduce(self, partials: List[torch.Tensor]) -> torch.Tensor:
        """The shards' partials summed in fp32 on the first device, rounded once to bf16."""
        return self._reduce_fp32(partials).to(torch.bfloat16)

    def _reduce_fp32(self, partials: List[torch.Tensor]) -> torch.Tensor:
        total = partials[0].to(torch.float32)
        for partial in partials[1:]:
            total = total + partial.to(self.devices[0], torch.float32, non_blocking=True)
        return total

    def _apply(self, x: torch.Tensor, cache_k: Optional[List[torch.Tensor]] = None,
               cache_v: Optional[List[torch.Tensor]] = None, index=None, params: Optional[List[Shard]] = None):
        """The block, tensor-parallel: ``x`` [batch, seq, hid] on the first device; with
        per-shard caches (``shard_decode_cache``) and ``index``, one decode step that
        returns ``(y, cache_k, cache_v)``, as the block does. ``params``: the shards to
        run (the backend's own by default; the backward's leaves)."""
        block, parts = self.module, self._axis_size()
        params = self.params if params is None else params
        batch, seq, hid = x.shape
        heads, kv_heads = block.num_heads // parts, block.num_kv_heads // parts
        head_dim, eps = hid // block.num_heads, block.attention_norm.eps
        decoding = cache_k is not None
        offsets = [0] * parts
        if decoding:
            offsets = [index.to(device, non_blocking=True) if isinstance(index, torch.Tensor) else index
                       for device in self.devices]
        partials, new_k, new_v = [], [], []
        for r, (shard, xr) in enumerate(zip(params, self._broadcast(x))):
            w, offset = _weights(shard, _ATTENTION), offsets[r]
            normed = rms_norm(xr, w["attention_norm.weight"], eps)
            q = apply_rope(dense(normed, w["query.weight"]).reshape(batch, seq, heads, head_dim), block.rope_theta, offset)
            k = apply_rope(dense(normed, w["key.weight"]).reshape(batch, seq, kv_heads, head_dim), block.rope_theta, offset)
            v = dense(normed, w["value.weight"]).reshape(batch, seq, kv_heads, head_dim)
            if decoding:
                context, shard_k, shard_v = _decode_attention(q, k, v, cache_k[r], cache_v[r], offset,
                                                              groups=heads // kv_heads)
                new_k.append(shard_k)
                new_v.append(shard_v)
            else:
                if kv_heads != heads:  # grouped-query: each KV head serves heads/kv_heads queries
                    k = k.repeat_interleave(heads // kv_heads, dim=2)
                    v = v.repeat_interleave(heads // kv_heads, dim=2)
                context = attention_auto(q, k, v, causal=True)
            partials.append(dense(context.reshape(batch, seq, heads * head_dim), w["attention_out.weight"]))
        x = x + self._reduce(partials)
        partials = []
        for shard, xr in zip(params, self._broadcast(x)):
            w = _weights(shard, _FFN)
            normed = rms_norm(xr, w["ffn_norm.weight"], eps)
            gated = F.silu(dense(normed, w["ffn_gate.weight"])) * dense(normed, w["ffn_up.weight"])
            partials.append(dense(gated, w["ffn_down.weight"]))
        y = (x + self._reduce(partials)).to(torch.float32)
        return (y, new_k, new_v) if decoding else y

    def _input_grads(self, xs: List[torch.Tensor], grad_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The shard-by-shard forward under autograd: the input's gradient, and each shard
        tensor's left in its ``.grad`` for the optimizer's step (``ModuleBackend.backward``
        runs it and the step). A copied leaf's copies all get the sum of the shards'."""
        leaves = [{key: tensor.detach().requires_grad_(True) for key, tensor in shard.items()} for shard in self.params]
        y = self._apply(xs[0], params=leaves)
        flat = [leaf for shard in leaves for leaf in shard.values()]
        grad_x, *grads = torch.autograd.grad(y, [xs[0], *flat], grad_outputs=grad_outputs[0], allow_unused=True,
                                             materialize_grads=True)
        grads = iter(grads)
        shard_grads = [{key: next(grads) for key in shard} for shard in leaves]
        for key, dim in _SPLIT.items():
            if dim is None:  # summed once on the first device: every copy takes the same step
                total = self._reduce_fp32([shard[key] for shard in shard_grads])
                for shard, device in zip(shard_grads, self.devices):
                    shard[key] = total.to(device, non_blocking=True)
        for shard, shard_grad in zip(self.params, shard_grads):
            for key, tensor in shard.items():
                tensor.grad = shard_grad[key]
        return [grad_x]

    # ------------------------------------------------------------------ accounting

    def param_bytes(self) -> int:
        """Resident bytes of the whole block over the mesh, each replicated tensor
        (norm weights, an int8 leaf's absmax) counted once."""
        total = 0
        for key in self._shapes:
            pieces = [shard[key] for shard in self.snapshot_params()]
            if isinstance(pieces[0], QuantizedWindow):
                total += sum(_nbytes(piece.codes) for piece in pieces) + _nbytes(pieces[0].absmax)
            else:
                total += _nbytes(pieces[0]) if _SPLIT[key] is None else sum(_nbytes(piece) for piece in pieces)
        return total

    def param_bytes_per_device(self) -> int:
        """Resident parameter bytes of the largest shard: what each card holds when
        every shard has a card of its own (``param_bytes`` stays the block's total)."""
        return max(sum(_nbytes(value) if isinstance(value, torch.Tensor) else value.nbytes for value in shard.values())
                   for shard in self.snapshot_params())

    def get_info(self) -> Dict[str, Any]:
        info = super().get_info()
        info["mesh_devices"] = self._axis_size()
        info["shard_axis"] = self.shard_axis
        return info

    def __repr__(self):
        return f"MeshModuleBackend({self.name!r}, mesh={dict(self.mesh.shape)}, axis={self.shard_axis!r})"

    # ------------------------------------------------------------------ state

    def _gather(self, shards: List[Shard], pieces_of) -> Dict[str, torch.Tensor]:
        """``pieces_of(shard, key)`` of every shard, assembled into whole tensors on the
        host (new tensors, never the shards' own): cut leaves concatenated, a copied
        leaf taken from the first shard."""
        gathered = {}
        for key in self._shapes:
            if _SPLIT[key] is None:
                gathered[key] = pieces_of(shards[0], key).to("cpu", copy=True)
            else:
                gathered[key] = torch.cat([pieces_of(shard, key).to("cpu") for shard in shards], dim=_SPLIT[key])
        return gathered

    def gather_params(self) -> Dict[str, torch.Tensor]:
        """The shards gathered into the whole block's weights, fp32 on the host (int8:
        dequantized, bit for bit the whole tensor's dequantize)."""
        return self._gather(self.snapshot_params(), _dense_piece)

    def state_dict(self) -> bytes:
        """The bytes a single-device backend of the same weights and optimizer state
        writes: the gathered weights in flax layout, the optimizer's statistics assembled
        from the shards in its optax twin's layout (``{}`` for int8, as the reference
        writes)."""
        with self._state_lock:
            dense_params = self._gather(self.params, _dense_piece)
            opt_state = {} if self.optimizer is None else optax_state(
                self.optimizer, None, lambda slot: self._gather(self.params, lambda shard, key: self.optimizer.state.get(
                    shard[key], {}).get(slot, torch.zeros_like(shard[key]))))
            updates = self.update_count
        return flax_msgpack.to_bytes({"params": to_flax_tree(dense_params), "opt_state": opt_state, "updates": updates})

    def load_state_dict(self, blob: bytes) -> None:
        """Restore a blob of either package's backend: the weights, and the optimizer's
        statistics where its optax twin wrote them, go to their shards."""
        restored = flax_msgpack.msgpack_restore(blob)
        self.load_params(from_flax_albert_params(restored["params"]))
        with self._state_lock:
            if self.optimizer is not None:
                load_optax_state(self.optimizer, None, restored.get("opt_state") or {}, lambda key, whole: list(
                    zip((shard[key] for shard in self.params), self._split_leaf(key, whole))))
            self.update_count = int(restored.get("updates", 0))


def _nbytes(tensor: torch.Tensor) -> int:
    return tensor.numel() * tensor.element_size()


def _dense_piece(shard: Shard, key: str) -> torch.Tensor:
    """A shard's piece of a leaf, an int8 window dequantized (transient)."""
    return shard[key].dequantize() if isinstance(shard[key], QuantizedWindow) else shard[key]


def _weights(shard: Shard, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """A shard's weights for one stage, int8 windows dequantized (transient)."""
    return {name: _dense_piece(shard, name) for name in names}
