"""ModuleBackend: one expert = an ``nn.Module`` and its parameters on one device
(the port of hivemind_tpu/moe/server/module_backend.py).

The backend owns the parameters as a dict (``name -> tensor``, or
``QuantizedTensor`` for int8 weight-only serving) and runs the module through
``torch.func.functional_call`` on ``dequantize_tree(params)`` — the counterpart
of the JAX backend's ``module.apply({"params": dequantize_tree(params)})``. The
module itself is kept as a shell on the ``meta`` device, so an int8 backend holds
only its int8 codes resident. PyTorch runs eagerly on any batch size, so nothing
is padded to a bucket; ``bucket_batch_size`` still sizes the TaskPool's reused
assembly buffers.

Training: ``backward`` takes the gradients with ``functional_call`` on parameter
tensors that require grad and ``torch.autograd.grad``, then applies one step of
the backend's optimizer (built by the ``optimizer`` factory over the parameter
tensors). The step updates the parameters IN PLACE, so a 7B-width block keeps no
second copy of its weights. ``forward`` and ``backward`` both hold
``_state_lock`` for as long as they use the parameters, so no forward reads a
tensor while a step rewrites it (the ``Runtime`` thread runs one batch at a time
anyway; the lock covers callers outside it). Every kernel is queued on the same
stream, so work queued before a step runs before it on the card too.

State: ``state_dict()`` writes the JAX backend's blob, byte for byte where the
state is the same: flax's msgpack format (``utils/flax_msgpack.py``) of
``{"params", "opt_state", "updates"}``, the parameters in flax layout
(``convert.to_flax_tree``: kernels ``[in, out]``) and the optimizer state in the
layout of its optax twin. ``load_state_dict(blob)`` reads a blob of either
package. Checkpoints (``checkpoints.py``) and replica transfers
(``rpc_replica_state``) carry these blobs, so a port server restores a JAX
server's checkpoint and the reverse.

Telemetry: ``forward`` and ``backward`` count the bytes they copy between host
and device in ``hivemind_device_transfer_bytes_total``: the unpadded batch, as
the port sends it (the JAX backend counts its padded bucket).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from hivemind_tpu_torch.convert import from_flax_albert_params, to_flax_tree
from hivemind_tpu_torch.moe.server.layers import init_parameters
from hivemind_tpu_torch.ops.quantized_params import (
    QuantizedTensor,
    dequantize_tree,
    quantize_params,
    tree_param_bytes,
)
from hivemind_tpu_torch.telemetry.device import record_transfer
from hivemind_tpu_torch.utils import flax_msgpack
from hivemind_tpu_torch.utils.device import resolve_device
from hivemind_tpu_torch.utils.tensor_descr import BatchTensorDescriptor


def bucket_batch_size(n: int, max_batch_size: int) -> int:
    """Next power of two ≥ n (capped)."""
    bucket = 1
    while bucket < n:
        bucket *= 2
    return min(bucket, max(max_batch_size, n))


def tensor_nbytes(tensor: torch.Tensor) -> int:
    """Bytes of a tensor's elements, read from its metadata (no device sync)."""
    return tensor.numel() * tensor.element_size()


def _as_tuple(value) -> tuple:
    return tuple(value) if isinstance(value, (tuple, list)) else (value,)


class ModuleBackend:
    """See module docstring.

    :param module: an ``nn.Module`` taking one or several tensors and returning one
        tensor or a tuple of tensors
    :param sample_input: schema-defining input WITH batch dim (single-input experts)
    :param sample_inputs: schema-defining inputs for multi-input experts
    :param optimizer: a factory ``params -> torch.optim.Optimizer`` over the
        expert's parameter tensors, stepped on every ``backward``; None is plain
        SGD with learning rate 0 (the expert reports gradients and stays as it is)
    :param params: the expert's weights (``name -> tensor``, matching the module's
        parameter names and shapes), e.g. a checkpoint's; when omitted, the
        parameters are initialized from ``rng_seed``
    :param rng_seed: seeds the ``torch.Generator`` that initializes the parameters
    :param weight_quantization: ``"int8"`` stores the expert's weight matrices with
        the blockwise absmax codec (4x less resident memory; dense weights are
        materialized transiently inside each forward). Serving-only: ``backward``
        raises.
    :param device: ``"cuda"`` by default; ``"cpu"`` runs the plain PyTorch path.
        Without a card, the default raises.
    """

    def __init__(
        self,
        name: str,
        module: nn.Module,
        *,
        sample_input: Optional[np.ndarray] = None,
        sample_inputs: Optional[Sequence[np.ndarray]] = None,
        optimizer: Optional[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        max_batch_size: int = 4096,
        rng_seed: int = 0,
        weight_quantization: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if weight_quantization not in (None, "int8"):
            raise ValueError(f"unsupported weight_quantization {weight_quantization!r}")
        if (sample_input is None) == (sample_inputs is None):
            raise ValueError("provide exactly one of sample_input / sample_inputs")
        if sample_inputs is None:
            sample_inputs = (sample_input,)
        sample_inputs = tuple(np.asarray(sample) for sample in sample_inputs)
        self.device = resolve_device(device)
        self.name, self.max_batch_size = name, max_batch_size
        self.weight_quantization = weight_quantization
        self._state_lock = threading.Lock()
        self._make_optimizer = optimizer or (lambda tensors: torch.optim.SGD(tensors, lr=0.0))
        self.update_count = 0
        # how a peer rebuilds this expert from the layer registry before loading its
        # state blob (replication.py); None: it replicates from its checkpoint instead
        self.replication_spec: Optional[Dict[str, Any]] = None

        if any(True for _ in module.buffers()):
            raise ValueError("ModuleBackend serves modules whose state is parameters only")
        sample_out = self._init_state(module, params, rng_seed, sample_inputs)

        self.num_inputs, self.num_outputs = len(sample_inputs), len(sample_out)
        self.forward_schema = tuple(BatchTensorDescriptor.from_tensor(sample) for sample in sample_inputs)
        self.outputs_schema = tuple(BatchTensorDescriptor.from_tensor(out) for out in sample_out)

    def _init_state(self, module: nn.Module, params: Optional[Dict[str, torch.Tensor]], rng_seed: int,
                    sample_inputs: Sequence[np.ndarray]) -> tuple:
        """Set the module shell, ``params`` and the optimizer; returns the outputs of
        the first sample row (they define the output schema)."""
        if params is None:
            # to_empty + a seeded init: a module built on the meta device is
            # allocated once, on the target device
            module = module.to_empty(device=self.device)
            init_parameters(module, torch.Generator(device=self.device).manual_seed(rng_seed))
            dense = {key: tensor.detach() for key, tensor in module.state_dict().items()}
        # a stateless shell: the backend owns the parameters
        self.module = module.to("meta").eval().requires_grad_(False)
        self._shapes = {key: tuple(tensor.shape) for key, tensor in self.module.state_dict().items()}
        if params is not None:
            dense = self._dense_params(params)
        with torch.inference_mode():
            samples = tuple(self._to_device(sample[:1]) for sample in sample_inputs)
            sample_out = _as_tuple(torch.func.functional_call(self.module, dense, samples))
        self.params = quantize_params(dense) if self.weight_quantization else dense
        self.optimizer = None if self.weight_quantization else self._make_optimizer(list(self.params.values()))
        return sample_out

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    def _check_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Raise unless ``params`` has the module's names and shapes."""
        if set(params) != set(self._shapes):
            missing, unexpected = sorted(set(self._shapes) - set(params)), sorted(set(params) - set(self._shapes))
            raise KeyError(f"expert {self.name!r}: missing {missing}, unexpected {unexpected}")
        for key, tensor in params.items():
            if tuple(tensor.shape) != self._shapes[key]:
                raise ValueError(f"expert {self.name!r}: {key} has shape {tuple(tensor.shape)}, expected {self._shapes[key]}")

    def _dense_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``params`` checked against the module's names and shapes, as fp32 on the device."""
        self._check_params(params)
        # copied: the optimizer updates the backend's tensors in place
        return {key: torch.as_tensor(tensor).to(self.device, torch.float32, copy=True) for key, tensor in params.items()}

    # ------------------------------------------------------------------ execution

    def snapshot_params(self) -> Dict[str, Union[torch.Tensor, QuantizedTensor]]:
        """The current parameter dict under the state lock (for read-only use; a
        later ``backward`` updates its tensors in place)."""
        with self._state_lock:
            return self.params

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Replace the expert's weights (e.g. with a pretrained checkpoint's). The
        dict must match the init schema (names and shapes); quantized backends
        re-encode to int8 on the device; trainable ones restart the optimizer's
        statistics for the new weights."""
        dense = self._dense_params(params)
        new_params = quantize_params(dense) if self.weight_quantization else dense
        new_optimizer = None if self.weight_quantization else self._make_optimizer(list(new_params.values()))
        with self._state_lock:
            self.params, self.optimizer = new_params, new_optimizer

    def param_bytes(self) -> int:
        """Resident bytes of this expert's weights (int8 codes count, not the
        transient dense copies) — the device-memory budgeting input."""
        return tree_param_bytes(self.snapshot_params())

    def _check_count(self, what: str, tensors: Sequence[np.ndarray], expected: int) -> None:
        if len(tensors) != expected:
            raise ValueError(f"expert {self.name!r}: {what} takes {expected} tensors, got {len(tensors)}")

    def _apply(self, *args):
        """The module on the current weights: a forward, or a decode step when
        ``args`` carry caches. The caller holds ``_state_lock`` and inference mode."""
        return torch.func.functional_call(self.module, dequantize_tree(self.params), args)

    def init_decode_cache(self, batch: int, max_len: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """A decode session's fresh caches (``DecodeSessionManager``): a list of one
        tensor a shard of the block, here one, on the backend's device."""
        cache_k, cache_v = self.module.init_decode_cache(batch, max_len, self.device)
        return [cache_k], [cache_v]

    def decode_step(self, x: torch.Tensor, cache_k: List[torch.Tensor], cache_v: List[torch.Tensor], index):
        """One decode step on caches made by ``init_decode_cache`` (or their stack):
        returns ``(y, cache_k, cache_v)``. The caller holds ``_state_lock`` and
        inference mode."""
        y, new_k, new_v = self._apply(x, *cache_k, *cache_v, index)
        return y, [new_k], [new_v]

    def forward(self, *inputs: np.ndarray) -> List[np.ndarray]:
        """Inference on a concatenated batch (no parameter updates)."""
        self._check_count("forward", inputs, self.num_inputs)
        xs = tuple(self._to_device(x) for x in inputs)
        record_transfer(sum(tensor_nbytes(x) for x in xs), "host_to_device")
        with self._state_lock, torch.inference_mode():
            outs = _as_tuple(self._apply(*xs))
            results = [out.to("cpu").numpy() for out in outs]
        record_transfer(sum(r.nbytes for r in results), "device_to_host")
        return results

    def backward(self, *tensors: np.ndarray) -> List[np.ndarray]:
        """Gradients with respect to every input; ALSO applies one optimizer step to
        the expert (the server trains on every backward call). ``tensors`` = the
        forward inputs followed by one gradient per output."""
        if self.weight_quantization is not None:
            raise RuntimeError(
                f"expert {self.name!r} serves int8 weight-only (inference-only): "
                f"backward/training is not supported on quantized weights"
            )
        self._check_count("backward (inputs, then output gradients)", tensors, self.num_inputs + self.num_outputs)
        xs = [self._to_device(x).requires_grad_(True) for x in tensors[: self.num_inputs]]
        grad_outputs = [self._to_device(g) for g in tensors[self.num_inputs:]]
        record_transfer(sum(tensor_nbytes(t) for t in (*xs, *grad_outputs)), "host_to_device")
        with self._state_lock, torch.enable_grad():
            grads = self._input_grads(xs, grad_outputs)
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.update_count += 1
            grads_in = [grad.to("cpu").numpy() for grad in grads]
        record_transfer(sum(grad.nbytes for grad in grads_in), "device_to_host")
        return grads_in

    def _input_grads(self, xs: List[torch.Tensor], grad_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The inputs' gradients, each parameter tensor's left in its ``.grad`` for the
        optimizer's step. The caller holds ``_state_lock`` with autograd on."""
        leaves = {key: tensor.detach().requires_grad_(True) for key, tensor in self.params.items()}
        outs = _as_tuple(torch.func.functional_call(self.module, leaves, tuple(xs)))
        # an unused parameter (or input) gets a zero gradient, not None: optimizers
        # skip a None, while optax updates it (weight decay, moment decay) as the
        # JAX backend does
        grads = torch.autograd.grad(outs, [*xs, *leaves.values()], grad_outputs=grad_outputs,
                                    allow_unused=True, materialize_grads=True)
        for tensor, grad in zip(self.params.values(), grads[self.num_inputs:]):
            tensor.grad = grad
        return list(grads[: self.num_inputs])

    # ------------------------------------------------------------------ metadata

    def get_info(self) -> Dict[str, Any]:
        return dict(
            forward_schema=list(self.forward_schema),
            outputs_schema=list(self.outputs_schema),
            max_batch_size=self.max_batch_size,
            updates=self.update_count,
        )

    # ------------------------------------------------------------------ state

    def state_dict(self) -> bytes:
        """The expert's state as the JAX backend writes it: flax's msgpack bytes of
        ``{"params": flax tree, "opt_state": optax tree, "updates": int}``. An int8
        backend writes its dense (dequantized) weights and ``{}``, as the
        reference does; ``load_state_dict`` quantizes them again."""
        with self._state_lock:
            params = to_flax_tree(dequantize_tree(self.params))
            opt_state = {} if self.optimizer is None else optax_state(self.optimizer, self.params)
            updates = self.update_count
        return flax_msgpack.to_bytes({"params": params, "opt_state": opt_state, "updates": updates})

    def load_state_dict(self, blob: bytes) -> None:
        """Restore a blob of ``state_dict`` (either package's): the weights, the
        optimizer's statistics where the optimizer has an optax twin (see
        :func:`optax_state`; any other optimizer restarts its statistics, as
        ``load_params`` does) and the update count. An int8 backend quantizes the
        restored weights."""
        restored = flax_msgpack.msgpack_restore(blob)
        dense = self._dense_params(from_flax_albert_params(restored["params"]))
        if self.weight_quantization:
            new_params, new_optimizer = quantize_params(dense), None
        else:
            new_params, new_optimizer = dense, self._make_optimizer(list(dense.values()))
            load_optax_state(new_optimizer, new_params, restored.get("opt_state") or {})
        with self._state_lock:
            self.params, self.optimizer = new_params, new_optimizer
            self.update_count = int(restored.get("updates", 0))


# ---------------------------------------------------------------------- optax twins
#
# A torch optimizer's statistics as the optax optimizer it equals writes them
# (flax's state-dict form of optax's state tuple):
# - Adam (no weight decay, no amsgrad) is optax.adam: {"0": {count, mu, nu}, "1": {}};
# - SGD is optax.sgd: {"0": {}, "1": {}}, or {"0": {"trace": tree}, "1": {}} with
#   momentum (no dampening, no Nesterov);
# - any other optimizer writes {} and restarts its statistics on load.
# ``count`` is optax's int32 step counter (torch's float ``step``), and the moments
# of a 2-D weight are transposed as its kernel is.


def _optax_layout(optimizer: torch.optim.Optimizer) -> Optional[str]:
    group = optimizer.param_groups[0]
    kind = type(optimizer)
    if kind is torch.optim.Adam and not group.get("amsgrad") and not group.get("weight_decay"):
        return "adam"
    if kind is torch.optim.SGD and not group.get("nesterov") and not group.get("dampening"):
        return "sgd_momentum" if group.get("momentum") else "sgd"
    return None


def optax_state(optimizer: torch.optim.Optimizer, params: Optional[Dict[str, torch.Tensor]],
                moments: Optional[Callable[[str], Dict[str, torch.Tensor]]] = None) -> Dict[str, Any]:
    """``optimizer``'s statistics over ``params`` in its optax twin's layout ({} when
    it has none). ``moments(slot)`` gives one slot's tensors keyed like the block's
    parameters: by default each tensor of ``params``'s own (a serving mesh assembles
    them from its shards instead)."""
    layout = _optax_layout(optimizer)
    if layout is None:
        return {}
    if moments is None:
        moments = lambda slot: {key: optimizer.state.get(tensor, {}).get(slot, torch.zeros_like(tensor))
                                for key, tensor in params.items()}
    if layout in ("sgd", "sgd_momentum"):
        first = {"trace": to_flax_tree(moments("momentum_buffer"))} if layout == "sgd_momentum" else {}
        return {"0": first, "1": {}}
    steps = [state["step"] for state in optimizer.state.values() if "step" in state]
    count = np.asarray(int(steps[0]) if steps else 0, np.int32)
    return {"0": {"count": count, "mu": to_flax_tree(moments("exp_avg")), "nu": to_flax_tree(moments("exp_avg_sq"))},
            "1": {}}


def load_optax_state(optimizer: torch.optim.Optimizer, params: Optional[Dict[str, torch.Tensor]], state: Dict[str, Any],
                     place: Optional[Callable[[str, torch.Tensor], List[Tuple[torch.Tensor, torch.Tensor]]]] = None) -> None:
    """Set ``optimizer``'s statistics from an optax state tree (the inverse of
    :func:`optax_state`); a layout the optimizer does not have leaves it fresh.
    ``place(key, whole)`` gives the ``(parameter tensor, value)`` pairs that a whole
    statistic of the parameter ``key`` lands on: by default ``params[key]`` and the
    whole (a serving mesh cuts it into its shards instead)."""
    layout, first = _optax_layout(optimizer), state.get("0")
    if layout is None or not isinstance(first, dict):
        return
    if place is None:
        place = lambda key, whole: [(params[key], whole.to(params[key].device))]

    if layout == "sgd_momentum" and "trace" in first:
        for key, value in from_flax_albert_params(first["trace"]).items():
            for tensor, piece in place(key, value):
                optimizer.state[tensor] = {"momentum_buffer": piece}
    elif layout == "adam" and {"count", "mu", "nu"} <= set(first):
        mu, nu = from_flax_albert_params(first["mu"]), from_flax_albert_params(first["nu"])
        for key in mu:
            for (tensor, m), (_, v) in zip(place(key, mu[key]), place(key, nu[key])):
                optimizer.state[tensor] = {"step": torch.tensor(float(first["count"]), dtype=torch.float32),
                                           "exp_avg": m, "exp_avg_sq": v}
