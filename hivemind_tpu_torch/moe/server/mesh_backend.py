"""Tensor-parallel block serving over a serving mesh (the port of
hivemind_tpu/moe/server/mesh_backend.py): the serving unit is a list of devices,
not one card.

The JAX package lets GSPMD shard a block's parameters and KV caches over a device
mesh inside one process (``run_server --mesh_devices`` takes the first N local
devices), so a block too big for one chip is served by a slice. The port keeps
that shape: a :class:`ServingMesh` is an explicit list of ``torch.device``s held
by the one process that runs the Runtime, and a :class:`MeshModuleBackend` serves
one registered block over it, Megatron style, by that block's tensor-parallel
plan (``_PLANS``). A plan names, for each leaf of the block, whether it is

- cut along the output features of its ``nn.Linear`` weight ``[out, in]`` (column
  parallel: ``query``, ``key``, ``value``, the first ffn Dense, and their biases),
- cut along the input features (row parallel: ``attention_out`` and the last ffn
  Dense), its bias held once, on ``devices[0]``, and added once after the reduce,
- copied to every shard (a pre-norm's weights), or
- held by ``devices[0]`` alone (what runs before the broadcast or after the reduce:
  a post-norm, the dropout mask, ``nop``'s scale);

and the block's stages: each a column part, a local op (attention or the ffn's
activation) and a row part on every shard, the reduce, and what runs after it.

Any mesh size N: shard r takes query heads ``[⌊rH/N⌋, ⌊(r+1)H/N⌋)`` and the KV
heads they read, ``[⌊h0/g⌋, ⌊(h1-1)/g⌋]`` with g = H / KV heads, so a KV head that
two shards need is copied to both; the ffn columns are cut by the same floor rule.
A shard with no heads adds no attention partial. Each shard computes its partial on
its own device with the blocks' own functions (``layers/common.py``). The partials
come out of each shard's GEMM in bf16, as the block's Dense output does; they are
summed in fp32 on ``devices[0]``, the row-parallel bias is added, the sum is rounded
once to bf16 and the stage's tail runs there; the result goes to every shard for
the next stage. The single device adds that bias inside its bf16 Dense output, so
the two round differently by at most one bf16 step. Work for distinct cards is
queued without a sync, so those cards run concurrently; N shards on one card run
one after another. The rest of the serving stack (``Server``,
``ConnectionHandler``, task pools, decode sessions, ``RemoteSequential``) is
unchanged: a client cannot tell a mesh from one card.

Int8 serving: each leaf is quantized whole by the blockwise kernel (bit for bit
the JAX package's codes and absmax), and each shard keeps its rows or columns of
the codes with the whole absmax (``ops/quantized_params.py::QuantizedWindow``).
KV caches are split over the kv-heads axis by each shard's KV range
(``shard_decode_cache``): a decode session holds one cache a shard, on the shard's
device, and a copied KV head has a cache on each shard that reads it.

Training: ``backward`` runs the same shard-by-shard forward under autograd, which
carries the gradients back through the cross-device copies of the broadcast and of
the fp32 reduce (so each shard's attention runs the flash backward kernels on its own
card), then applies one step of the backend's optimizer, built over every shard's
tensors. A copied leaf (a norm weight, a KV head's rows) gets the sum of its
copies' gradients, computed once on the first device and given to every copy, so
the copies take the same step and stay identical. ``state_dict`` assembles the
optimizer's statistics from the shards in the single-device optax layout, and
``load_state_dict`` cuts them back. An int8 mesh refuses the backward, as an int8
single-device backend does.

Accounting differs from the JAX package's where N does not divide a leaf: the JAX
package replicates a leaf whose last axis does not divide N, the port cuts it
unevenly, so the two packages' per-device bytes differ for such an N (the outputs
agree). ``param_bytes`` counts every distinct tensor once (the block's bytes);
``param_bytes_per_device`` is the largest shard's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hivemind_tpu_torch.convert import from_flax_albert_params, to_flax_tree
from hivemind_tpu_torch.moe.server.layers import init_parameters
from hivemind_tpu_torch.moe.server.layers.common import (
    CausalTransformerExpert,
    FeedforwardExpert,
    LlamaBlockExpert,
    NopExpert,
    TransformerExpert,
    _decode_attention,
    _gelu,
    apply_rope,
    dense,
    rms_norm,
)
from hivemind_tpu_torch.moe.server.layers.dropout import DeterministicDropoutExpert
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend, load_optax_state, optax_state
from hivemind_tpu_torch.ops.flash_attention import attention_auto
from hivemind_tpu_torch.ops.quantized_params import QuantizedTensor, QuantizedWindow, cut_window, quantize_params
from hivemind_tpu_torch.utils import flax_msgpack
from hivemind_tpu_torch.utils.device import resolve_device

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


# ---------------------------------------------------------------------- the plans


class Leaf(NamedTuple):
    """Where a leaf lives: ``"cut"`` along ``dim`` of the ``nn.Linear`` weight
    ``[out, in]`` (0: output features, column parallel; 1: input features, row
    parallel; a bias ``[out]`` along 0) by whole ``unit``s (``"heads"``, ``"kv"`` or
    ``"ffn"``), ``"copy"`` on every shard, or ``"first"``: on ``devices[0]`` alone."""

    kind: str
    dim: int = 0
    unit: str = ""


COPY, FIRST = Leaf("copy"), Leaf("first")
COLUMN = {unit: Leaf("cut", 0, unit) for unit in ("heads", "kv", "ffn")}
ROW = {unit: Leaf("cut", 1, unit) for unit in ("heads", "ffn")}


class Stage(NamedTuple):
    """One tensor-parallel stage: ``shard(backend, call, r, weights, x)`` is shard r's
    column part, local op and row part (its bf16 partial), run only on shards that
    hold some of ``unit``; the partials are summed in fp32 on ``devices[0]``,
    ``bias`` (a row-parallel leaf held there) is added and the sum is rounded to bf16
    (``h``); ``after(backend, weights, x, h)`` runs there on shard 0's weights and
    gives the stage's output, which the next stage broadcasts."""

    unit: str
    shard: Callable
    bias: Optional[str]
    after: Callable


class Plan(NamedTuple):
    """A block's leaves (``Leaf`` by parameter name), its stages, and ``prologue(backend,
    weights, inputs)``: what runs on ``devices[0]`` before the first broadcast."""

    leaves: Dict[str, Leaf]
    stages: Tuple[Stage, ...]
    prologue: Callable = lambda backend, w, inputs: inputs[0]


def _layer_norm(x: torch.Tensor, w: Shard, name: str, eps: float) -> torch.Tensor:
    """The blocks' LayerNorm (fp32 statistics, bf16 out) on shard weights."""
    weight, bias = w[f"{name}.weight"], w[f"{name}.bias"]
    return F.layer_norm(x.to(torch.float32), weight.shape, weight, bias, eps).to(torch.bfloat16)


def _qkv_attention(backend, call, r, w, normed, causal: bool, rope: Optional[float] = None,
                   biased: bool = True) -> torch.Tensor:
    """Shard r's attention partial: its query heads and KV heads (column parallel),
    attention over them (the flash kernel, or a decode step on the shard's caches),
    and its input columns of ``attention_out`` (row parallel, bf16)."""
    batch, seq = normed.shape[0], normed.shape[1]
    heads, kv_heads, head_dim = backend._count(r, "heads"), backend._count(r, "kv"), backend._head_dim
    bias = (lambda name: w[f"{name}.bias"]) if biased else (lambda name: None)
    q = dense(normed, w["query.weight"], bias("query")).reshape(batch, seq, heads, head_dim)
    k = dense(normed, w["key.weight"], bias("key")).reshape(batch, seq, kv_heads, head_dim)
    v = dense(normed, w["value.weight"], bias("value")).reshape(batch, seq, kv_heads, head_dim)
    if rope is not None:
        q, k = apply_rope(q, rope, call.offsets[r]), apply_rope(k, rope, call.offsets[r])
    kv_map = backend._kv_maps[r]
    if call.decoding:
        context, call.cache_k[r], call.cache_v[r] = _decode_attention(q, k, v, call.cache_k[r], call.cache_v[r],
                                                                      call.offsets[r], kv_map=kv_map)
    else:
        if kv_map is not None:  # grouped-query: each query head reads its KV head's copy
            k, v = k.index_select(2, kv_map), v.index_select(2, kv_map)
        context = attention_auto(q, k, v, causal=causal)
    return dense(context.reshape(batch, seq, heads * head_dim), w["attention_out.weight"])


def _ffn_partial(up: str, down: str, activation):
    return lambda backend, call, r, w, x: dense(activation(dense(x, w[f"{up}.weight"], w[f"{up}.bias"])),
                                                w[f"{down}.weight"])


def _llama_plan(block: LlamaBlockExpert) -> Plan:
    eps = block.attention_norm.eps

    def attention(backend, call, r, w, x):
        return _qkv_attention(backend, call, r, w, rms_norm(x, w["attention_norm.weight"], eps), True,
                              rope=block.rope_theta, biased=False)

    def ffn(backend, call, r, w, x):
        normed = rms_norm(x, w["ffn_norm.weight"], eps)
        return dense(F.silu(dense(normed, w["ffn_gate.weight"])) * dense(normed, w["ffn_up.weight"]), w["ffn_down.weight"])

    leaves = {"attention_norm.weight": COPY, "query.weight": COLUMN["heads"], "key.weight": COLUMN["kv"],
              "value.weight": COLUMN["kv"], "attention_out.weight": ROW["heads"], "ffn_norm.weight": COPY,
              "ffn_gate.weight": COLUMN["ffn"], "ffn_up.weight": COLUMN["ffn"], "ffn_down.weight": ROW["ffn"]}
    return Plan(leaves, (Stage("heads", attention, None, lambda b, w, x, h: x + h),
                         Stage("ffn", ffn, None, lambda b, w, x, h: (x + h).to(torch.float32))))


_ATTENTION_LEAVES = {"query.weight": COLUMN["heads"], "query.bias": COLUMN["heads"], "key.weight": COLUMN["kv"],
                     "key.bias": COLUMN["kv"], "value.weight": COLUMN["kv"], "value.bias": COLUMN["kv"],
                     "attention_out.weight": ROW["heads"], "attention_out.bias": FIRST,
                     "ffn_up.weight": COLUMN["ffn"], "ffn_up.bias": COLUMN["ffn"], "ffn_down.weight": ROW["ffn"],
                     "ffn_down.bias": FIRST}


def _causal_transformer_plan(block: CausalTransformerExpert) -> Plan:
    eps = block.attention_norm.eps

    def attention(backend, call, r, w, x):
        return _qkv_attention(backend, call, r, w, _layer_norm(x, w, "attention_norm", eps), True)

    def ffn(backend, call, r, w, x):
        return dense(_gelu(dense(_layer_norm(x, w, "ffn_norm", eps), w["ffn_up.weight"], w["ffn_up.bias"])),
                     w["ffn_down.weight"])

    norms = {f"{norm}.{leaf}": COPY for norm in ("attention_norm", "ffn_norm") for leaf in ("weight", "bias")}
    return Plan({**_ATTENTION_LEAVES, **norms},
                (Stage("heads", attention, "attention_out.bias", lambda b, w, x, h: x + h),
                 Stage("ffn", ffn, "ffn_down.bias", lambda b, w, x, h: (x + h).to(torch.float32))))


def _transformer_plan(block: TransformerExpert) -> Plan:
    eps = block.LayerNorm_0.eps
    norms = {f"LayerNorm_{i}.{leaf}": FIRST for i in (0, 1) for leaf in ("weight", "bias")}
    return Plan({**_ATTENTION_LEAVES, **norms}, (
        Stage("heads", lambda b, call, r, w, x: _qkv_attention(b, call, r, w, x, False), "attention_out.bias",
              lambda b, w, x, h: _layer_norm(x + h, w, "LayerNorm_0", eps)),
        Stage("ffn", _ffn_partial("ffn_up", "ffn_down", _gelu), "ffn_down.bias",
              lambda b, w, x, h: _layer_norm(x + h, w, "LayerNorm_1", eps).to(torch.float32))))


def _ffn_plan(block: FeedforwardExpert) -> Plan:
    eps = block.LayerNorm_0.eps
    leaves = {"Dense_0.weight": COLUMN["ffn"], "Dense_0.bias": COLUMN["ffn"], "Dense_1.weight": ROW["ffn"],
              "Dense_1.bias": FIRST, "LayerNorm_0.weight": FIRST, "LayerNorm_0.bias": FIRST}
    return Plan(leaves, (Stage("ffn", _ffn_partial("Dense_0", "Dense_1", _gelu), "Dense_1.bias",
                               lambda b, w, x, h: _layer_norm(x + h, w, "LayerNorm_0", eps).to(torch.float32)),))


def _det_dropout_plan(block: DeterministicDropoutExpert) -> Plan:
    keep = 1.0 - block.dropout.drop_prob
    leaves = {"Dense_0.weight": COLUMN["ffn"], "Dense_0.bias": COLUMN["ffn"], "Dense_1.weight": ROW["ffn"],
              "Dense_1.bias": FIRST}
    return Plan(leaves, (Stage("ffn", _ffn_partial("Dense_0", "Dense_1", torch.relu), "Dense_1.bias",
                               lambda b, w, x, h: h.to(torch.float32)),),
                prologue=lambda backend, w, inputs: inputs[0] * inputs[1] / keep)


def _nop_plan(block: NopExpert) -> Plan:
    return Plan({"scale": FIRST}, (), prologue=lambda backend, w, inputs: inputs[0] * w["scale"])


# each registered block's plan, by its module class; a module no plan names is refused
_PLANS: Dict[type, Callable[[nn.Module], Plan]] = {
    LlamaBlockExpert: _llama_plan,
    CausalTransformerExpert: _causal_transformer_plan,
    TransformerExpert: _transformer_plan,
    FeedforwardExpert: _ffn_plan,
    DeterministicDropoutExpert: _det_dropout_plan,
    NopExpert: _nop_plan,
}


def floor_ranges(count: int, parts: int) -> List[Tuple[int, int]]:
    """``[⌊r·count/parts⌋, ⌊(r+1)·count/parts⌋)`` for each of ``parts`` shards."""
    return [(r * count // parts, (r + 1) * count // parts) for r in range(parts)]


def kv_ranges(heads: int, kv_heads: int, parts: int) -> List[Tuple[int, int]]:
    """Each shard's KV heads ``[⌊h0/g⌋, ⌊(h1-1)/g⌋ + 1)``: those its query heads
    ``[h0, h1)`` read (g = heads / kv_heads); empty for a shard with no heads."""
    group = heads // kv_heads
    return [(h0 // group, (h1 - 1) // group + 1) if h1 > h0 else (h0 // group, h0 // group)
            for h0, h1 in floor_ranges(heads, parts)]


class _Call:
    """One call's per-shard state: the decode caches and their write offsets."""

    def __init__(self, backend: "MeshModuleBackend", decode):
        self.decoding = decode is not None
        self.offsets = [0] * len(backend.devices)
        if self.decoding:
            cache_k, cache_v, index = decode
            self.cache_k, self.cache_v = list(cache_k), list(cache_v)
            self.offsets = [index.to(device, non_blocking=True) if isinstance(index, torch.Tensor) else index
                            for device in backend.devices]


class MeshModuleBackend(ModuleBackend):
    """A :class:`ModuleBackend` whose block is served tensor-parallel over a
    :class:`ServingMesh` by the block's plan (see module docstring). ``params``, when
    given, is a host (or any device's) dict of the block's weights: each leaf goes
    straight to its shards. ``self.params`` is the list of the shards' parameter
    dicts (a ``"first"`` leaf is in shard 0's alone).

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
        make_plan = _PLANS.get(type(module))
        if make_plan is None:
            raise TypeError(f"MeshModuleBackend has no tensor-parallel plan for {type(module).__name__}; it serves "
                            f"{sorted(plan.__name__ for plan in _PLANS)}")
        self.plan = make_plan(module)
        if params is None:  # a seeded init on the host; each leaf then goes to its shards
            module = module.to_empty(device="cpu")
            init_parameters(module, torch.Generator().manual_seed(rng_seed))
            params = {key: tensor.detach() for key, tensor in module.state_dict().items()}
        self.module = module.to("meta").eval().requires_grad_(False)
        self._shapes = {key: tuple(tensor.shape) for key, tensor in self.module.state_dict().items()}
        if set(self._shapes) != set(self.plan.leaves):
            raise TypeError(f"{type(module).__name__} has leaves {sorted(self._shapes)}, its plan names "
                            f"{sorted(self.plan.leaves)}")
        self._cut_units(module)
        self.load_params(params)
        with torch.inference_mode():
            return (self._apply(*(self._to_device(sample[:1]) for sample in sample_inputs)),)

    def _cut_units(self, module: nn.Module) -> None:
        """Each shard's range of every unit, the elements a unit spans, and each
        shard's map from its query heads to its KV heads (None where they are the same)."""
        parts = self._axis_size()
        self._ranges: Dict[str, List[Tuple[int, int]]] = {}
        self._unit_size: Dict[str, int] = {"ffn": 1}
        for key, leaf in self.plan.leaves.items():
            if leaf.unit == "ffn":
                self._ranges["ffn"] = floor_ranges(self._shapes[key][leaf.dim], parts)
        heads = getattr(module, "num_heads", 0)
        self._kv_maps: List[Optional[torch.Tensor]] = [None] * parts
        if heads:
            kv_heads = getattr(module, "num_kv_heads", heads)
            self._head_dim = self._shapes["query.weight"][1] // heads
            self._unit_size.update(heads=self._head_dim, kv=self._head_dim)
            self._ranges["heads"] = floor_ranges(heads, parts)
            self._ranges["kv"] = kv_ranges(heads, kv_heads, parts)
            group = heads // kv_heads
            for r, ((h0, h1), (k0, k1)) in enumerate(zip(self._ranges["heads"], self._ranges["kv"])):
                if h1 - h0 != k1 - k0:
                    self._kv_maps[r] = torch.tensor([h // group - k0 for h in range(h0, h1)], device=self.devices[r])

    def _count(self, r: int, unit: str) -> int:
        start, stop = self._ranges[unit][r]
        return stop - start

    def _own(self, r: int, unit: str) -> Tuple[int, int]:
        """The part of shard r's range of ``unit`` that no earlier shard holds, as
        (offset into the shard's piece, length), in units."""
        start, stop = self._ranges[unit][r]
        seen = max([self._ranges[unit][s][1] for s in range(r)], default=start)
        first = min(max(start, seen), stop)
        return first - start, stop - first

    # ------------------------------------------------------------------ shardings

    def _axis_size(self) -> int:
        return int(self.mesh.shape[self.shard_axis])

    def leaf_spec(self, leaf) -> Tuple[Optional[str], ...]:
        """The JAX package's placement rule, kept as its public API: a leaf of ndim >= 2
        shards over its last axis when that divides the mesh; anything else replicates
        (``()``). The port places leaves by its plan instead (``self.plan.leaves``), so
        this rule drives no placement here; capacity comes from ``param_bytes_per_device``
        (``run_server`` passes it to ``plan_block_capacity`` with ``mesh_devices=1``:
        passing both would count the mesh twice)."""
        shape = tuple(getattr(leaf, "shape", ()))
        size = self._axis_size()
        if len(shape) >= 2 and shape[-1] % size == 0 and shape[-1] >= size:
            return (None,) * (len(shape) - 1) + (self.shard_axis,)
        return ()

    def _split_leaf(self, key: str, tensor: torch.Tensor, quantize: bool = True
                    ) -> List[Optional[Union[torch.Tensor, QuantizedWindow]]]:
        """One leaf as its shards' pieces, each on its device (None: a shard without
        it). An int8 leaf is quantized whole on ``devices[0]`` (the one leaf that is
        transient there) and cut."""
        leaf = self.plan.leaves[key]
        if leaf.kind == "first":
            return [tensor.to(self.devices[0], torch.float32, copy=True).contiguous()] + [None] * (len(self.devices) - 1)
        if leaf.kind == "copy":
            return [tensor.to(device, torch.float32, copy=True).contiguous() for device in self.devices]
        size = self._unit_size[leaf.unit]
        spans = [(start * size, stop * size) for start, stop in self._ranges[leaf.unit]]
        if quantize and self.weight_quantization:
            whole = quantize_params({key: tensor.to(self.devices[0], torch.float32)})[key]
            if isinstance(whole, QuantizedTensor):
                return [cut_window(whole, leaf.dim, start, stop, device)
                        for (start, stop), device in zip(spans, self.devices)]
        return [tensor.narrow(leaf.dim, start, stop - start).to(device, torch.float32, copy=True).contiguous()
                for (start, stop), device in zip(spans, self.devices)]

    def shard_decode_cache(self, cache_k: torch.Tensor, cache_v: torch.Tensor) -> Tuple[List[torch.Tensor], ...]:
        """A session's caches ``[batch, max_len, kv_heads, head_dim]`` as one tensor a
        shard, each holding the shard's KV heads on its device (a copied KV head on
        each shard that reads it). Meta tensors (shapes only) become zeros on each
        device."""

        def split(cache: torch.Tensor) -> List[torch.Tensor]:
            pieces = [cache.narrow(-2, start, stop - start) for start, stop in self._ranges["kv"]]
            return [torch.zeros(piece.shape, dtype=piece.dtype, device=device) if piece.is_meta
                    else piece.to(device, copy=True).contiguous() for piece, device in zip(pieces, self.devices)]

        return split(cache_k), split(cache_v)

    def init_decode_cache(self, batch: int, max_len: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """A decode session's fresh caches, one a shard: the shapes only, then each
        shard's zeros on its own device (no whole cache on any one device)."""
        return self.shard_decode_cache(*self.module.init_decode_cache(batch, max_len, "meta"))

    def decode_step(self, x: torch.Tensor, cache_k: List[torch.Tensor], cache_v: List[torch.Tensor], index):
        return self._run((x,), decode=(cache_k, cache_v, index))

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Replace the block's weights: each leaf lands straight on its shards (int8:
        quantized whole on the first device, then cut); a trainable mesh restarts its
        optimizer over the new shards."""
        self._check_params(params)
        shards: List[Shard] = [{} for _ in self.devices]
        for key, tensor in params.items():
            for shard, piece in zip(shards, self._split_leaf(key, torch.as_tensor(tensor))):
                if piece is not None:
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

    def _reduce_fp32(self, partials: List[torch.Tensor]) -> torch.Tensor:
        """The shards' partials summed in fp32 on the first device."""
        total = partials[0].to(self.devices[0], torch.float32)
        for partial in partials[1:]:
            total = total + partial.to(self.devices[0], torch.float32, non_blocking=True)
        return total

    def _apply(self, *inputs: torch.Tensor):
        return self._run(inputs)

    def _run(self, inputs: Sequence[torch.Tensor], params: Optional[List[Shard]] = None, decode=None):
        """The block, tensor-parallel: ``inputs`` on the first device; with ``decode``
        (per-shard caches from ``shard_decode_cache`` and the write index), one decode
        step that returns ``(y, cache_k, cache_v)``, as the block does. ``params``: the
        shards to run (the backend's own by default; the backward's leaves)."""
        params = self.params if params is None else params
        call, first = _Call(self, decode), _LazyWeights(params[0])
        x = self.plan.prologue(self, first, inputs)
        for stage in self.plan.stages:
            partials = []
            for r, (shard, xr) in enumerate(zip(params, self._broadcast(x))):
                if self._count(r, stage.unit):  # a shard with none of the stage's unit adds nothing
                    partials.append(stage.shard(self, call, r, _LazyWeights(shard), xr))
            total = self._reduce_fp32(partials)
            if stage.bias is not None:  # added once, after the reduce
                total = total + first[stage.bias].to(torch.bfloat16).to(torch.float32)
            x = stage.after(self, first, x, total.to(torch.bfloat16))
        return (x, call.cache_k, call.cache_v) if call.decoding else x

    def _input_grads(self, xs: List[torch.Tensor], grad_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The shard-by-shard forward under autograd: the inputs' gradients, and each shard
        tensor's left in its ``.grad`` for the optimizer's step (``ModuleBackend.backward``
        runs it and the step). A copied leaf's copies all get the sum of their gradients."""
        leaves = [{key: tensor.detach().requires_grad_(True) for key, tensor in shard.items()} for shard in self.params]
        y = self._run(xs, params=leaves)
        flat = [leaf for shard in leaves for leaf in shard.values()]
        grads = torch.autograd.grad(y, [*xs, *flat], grad_outputs=grad_outputs[0], allow_unused=True,
                                    materialize_grads=True)
        rest = iter(grads[len(xs):])
        shard_grads = [{key: next(rest) for key in shard} for shard in leaves]
        for key, leaf in self.plan.leaves.items():
            if leaf.kind == "copy":  # summed once on the first device: every copy takes the same step
                total = self._reduce_fp32([shard[key] for shard in shard_grads])
                for shard, device in zip(shard_grads, self.devices):
                    shard[key] = total.to(device, non_blocking=True)
            elif leaf.kind == "cut" and self._overlaps(leaf.unit):
                self._sum_copies(key, leaf, shard_grads)
        for shard, shard_grad in zip(self.params, shard_grads):
            for key, tensor in shard.items():
                tensor.grad = shard_grad[key]
        return list(grads[: len(xs)])

    def _overlaps(self, unit: str) -> bool:
        return any(self._own(r, unit)[1] != self._count(r, unit) for r in range(len(self.devices)))

    def _sum_copies(self, key: str, leaf: Leaf, shard_grads: List[Dict[str, torch.Tensor]]) -> None:
        """A cut leaf whose units some shards share (a KV head copied to two shards):
        the whole gradient summed on the first device, then each shard's piece of it."""
        size = self._unit_size[leaf.unit]
        whole = torch.zeros(self._shapes[key], dtype=torch.float32, device=self.devices[0])
        for (start, stop), shard in zip(self._ranges[leaf.unit], shard_grads):
            whole.narrow(leaf.dim, start * size, (stop - start) * size).add_(shard[key].to(self.devices[0]))
        for shard, piece in zip(shard_grads, self._split_leaf(key, whole, quantize=False)):
            shard[key] = piece

    # ------------------------------------------------------------------ accounting

    def _distinct(self, shards: List[Shard], key: str, piece_of) -> List:
        """``piece_of(shard, key)`` of the shards that hold ``key``, each narrowed to the
        units no earlier shard holds (a copied or first leaf: shard 0's alone)."""
        leaf = self.plan.leaves[key]
        if leaf.kind != "cut":
            return [piece_of(shards[0], key)]
        size, pieces = self._unit_size[leaf.unit], []
        for r, shard in enumerate(shards):
            offset, length = self._own(r, leaf.unit)
            pieces.append(piece_of(shard, key).narrow(leaf.dim, offset * size, length * size))
        return pieces

    def param_bytes(self) -> int:
        """Resident bytes of the whole block over the mesh, each distinct tensor counted
        once: a copied leaf, a copied KV head's rows and an int8 leaf's absmax once."""
        shards, total = self.snapshot_params(), 0
        for key, leaf in self.plan.leaves.items():
            if isinstance(shards[0][key], QuantizedWindow):
                # the codes are [in, out]: their transpose narrows as the nn.Linear weight does
                codes = self._distinct(shards, key, lambda shard, key: shard[key].codes.T)
                total += sum(_nbytes(piece) for piece in codes) + _nbytes(shards[0][key].absmax)
            else:
                total += sum(_nbytes(piece) for piece in self._distinct(shards, key, lambda shard, key: shard[key]))
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
        host (new tensors, never the shards' own): cut leaves concatenated, each unit
        from its first holder; a copied or first leaf from the first shard."""
        gathered = {}
        for key, leaf in self.plan.leaves.items():
            pieces = [piece.to("cpu") for piece in self._distinct(shards, key, pieces_of)]
            gathered[key] = torch.cat(pieces, dim=leaf.dim) if leaf.kind == "cut" else pieces[0].clone()
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
                load_optax_state(self.optimizer, None, restored.get("opt_state") or {}, lambda key, whole: [
                    (shard[key], piece) for shard, piece in zip(self.params, self._split_leaf(key, whole, quantize=False))
                    if piece is not None])
            self.update_count = int(restored.get("updates", 0))


def _nbytes(tensor: torch.Tensor) -> int:
    return tensor.numel() * tensor.element_size()


def _dense_piece(shard: Shard, key: str) -> torch.Tensor:
    """A shard's piece of a leaf, an int8 window dequantized (transient)."""
    return shard[key].dequantize() if isinstance(shard[key], QuantizedWindow) else shard[key]


class _LazyWeights(dict):
    """A shard's weights for one stage, each int8 window dequantized at its first read
    (transient), so a stage dequantizes only the leaves it uses."""

    def __init__(self, shard: Shard):
        super().__init__()
        self._shard = shard

    def __missing__(self, key: str) -> torch.Tensor:
        value = self[key] = _dense_piece(self._shard, key)
        return value
