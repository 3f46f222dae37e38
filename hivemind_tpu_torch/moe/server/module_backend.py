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

Telemetry: ``forward`` and ``backward`` count the bytes they copy between host
and device in ``hivemind_device_transfer_bytes_total``: the unpadded batch, as
the port sends it (the JAX backend counts its padded bucket).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch
from torch import nn

from hivemind_tpu_torch.moe.server.layers import init_parameters
from hivemind_tpu_torch.ops.quantized_params import (
    QuantizedTensor,
    dequantize_tree,
    quantize_params,
    tree_param_bytes,
)
from hivemind_tpu_torch.telemetry.device import record_transfer
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

    :param module: an ``nn.Module`` taking one tensor and returning one tensor or
        a tuple of tensors
    :param sample_input: schema-defining input WITH batch dim
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
        sample_input: np.ndarray,
        optimizer: Optional[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        max_batch_size: int = 4096,
        rng_seed: int = 0,
        weight_quantization: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if weight_quantization not in (None, "int8"):
            raise ValueError(f"unsupported weight_quantization {weight_quantization!r}")
        self.device = resolve_device(device)
        self.name, self.max_batch_size = name, max_batch_size
        self.weight_quantization = weight_quantization
        self._state_lock = threading.Lock()
        self._make_optimizer = optimizer or (lambda tensors: torch.optim.SGD(tensors, lr=0.0))
        self.update_count = 0

        if any(True for _ in module.buffers()):
            raise ValueError("ModuleBackend serves modules whose state is parameters only")
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
            sample = self._to_device(np.asarray(sample_input)[:1])
            sample_out = _as_tuple(torch.func.functional_call(self.module, dense, (sample,)))
        self.params = quantize_params(dense) if weight_quantization else dense
        self.optimizer = None if weight_quantization else self._make_optimizer(list(self.params.values()))

        self.forward_schema = (BatchTensorDescriptor.from_tensor(np.asarray(sample_input)),)
        self.outputs_schema = tuple(BatchTensorDescriptor.from_tensor(out) for out in sample_out)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).to(self.device)

    def _dense_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``params`` checked against the module's names and shapes, as fp32 on the device."""
        if set(params) != set(self._shapes):
            missing, unexpected = sorted(set(self._shapes) - set(params)), sorted(set(params) - set(self._shapes))
            raise KeyError(f"expert {self.name!r}: missing {missing}, unexpected {unexpected}")
        for key, tensor in params.items():
            if tuple(tensor.shape) != self._shapes[key]:
                raise ValueError(f"expert {self.name!r}: {key} has shape {tuple(tensor.shape)}, expected {self._shapes[key]}")
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

    def forward(self, x: np.ndarray) -> List[np.ndarray]:
        """Inference on a concatenated batch (no parameter updates)."""
        x = self._to_device(x)
        record_transfer(tensor_nbytes(x), "host_to_device")
        with self._state_lock, torch.inference_mode():
            outs = _as_tuple(torch.func.functional_call(self.module, dequantize_tree(self.params), (x,)))
            results = [out.to("cpu").numpy() for out in outs]
        record_transfer(sum(r.nbytes for r in results), "device_to_host")
        return results

    def backward(self, *tensors: np.ndarray) -> List[np.ndarray]:
        """Gradients with respect to the input; ALSO applies one optimizer step to
        the expert (the server trains on every backward call). ``tensors`` = the
        forward input followed by one gradient per output."""
        if self.weight_quantization is not None:
            raise RuntimeError(
                f"expert {self.name!r} serves int8 weight-only (inference-only): "
                f"backward/training is not supported on quantized weights"
            )
        if len(tensors) != 1 + len(self.outputs_schema):
            raise ValueError(f"expert {self.name!r}: expected the input and {len(self.outputs_schema)} output "
                             f"gradient(s), got {len(tensors)} tensors")
        x = self._to_device(tensors[0]).requires_grad_(True)
        grad_outputs = [self._to_device(g) for g in tensors[1:]]
        record_transfer(tensor_nbytes(x) + sum(tensor_nbytes(g) for g in grad_outputs), "host_to_device")
        with self._state_lock, torch.enable_grad():
            leaves = {key: tensor.detach().requires_grad_(True) for key, tensor in self.params.items()}
            outs = _as_tuple(torch.func.functional_call(self.module, leaves, (x,)))
            # an unused parameter gets a zero gradient, not None: optimizers skip a
            # None, while optax updates it (weight decay, moment decay) as the JAX backend does
            grads = torch.autograd.grad(outs, [x, *leaves.values()], grad_outputs=grad_outputs,
                                        allow_unused=True, materialize_grads=True)
            for tensor, grad in zip(self.params.values(), grads[1:]):
                tensor.grad = grad
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.update_count += 1
            grad_x = grads[0].to("cpu").numpy()
        record_transfer(grad_x.nbytes, "device_to_host")
        return [grad_x]

    # ------------------------------------------------------------------ metadata

    def get_info(self) -> Dict[str, Any]:
        return dict(
            forward_schema=list(self.forward_schema),
            outputs_schema=list(self.outputs_schema),
            max_batch_size=self.max_batch_size,
            updates=self.update_count,
        )
