"""Tensor schemas for expert signatures (the port's copy of
hivemind_tpu/utils/tensor_descr.py). Dtypes are canonical NUMPY names
(``"float32"``, ``"bfloat16"``), never torch's ``"torch.float32"``, so the
descriptors a torch peer publishes match a JAX peer's byte for byte.

``packb``/``unpackb`` import the msgpack serializer when called: the serializer
imports this module to register the descriptors' extension codes."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


def canonical_dtype_name(dtype: Any) -> str:
    """Normalize torch/numpy/str dtypes to a numpy name ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    name = dtype if isinstance(dtype, str) else str(dtype)
    if name == "bfloat16":
        return name
    return np.dtype(name).name


@dataclasses.dataclass(frozen=True)
class TensorDescriptor:
    """Declarative description of a tensor: enough to allocate it or validate a peer's."""

    shape: Tuple[int, ...]
    dtype: str = "float32"
    requires_grad: bool = False
    compression: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "dtype", canonical_dtype_name(self.dtype))

    @classmethod
    def from_tensor(cls, tensor: Any, compression: Optional[int] = None) -> "TensorDescriptor":
        """From a torch tensor or a numpy array."""
        requires_grad = bool(getattr(tensor, "requires_grad", False))
        return cls(tuple(tensor.shape), canonical_dtype_name(tensor.dtype), requires_grad, compression)

    @property
    def numel(self) -> int:
        out = 1
        for dim in self.shape:
            out *= dim
        return out

    @property
    def itemsize(self) -> int:
        return 2 if self.dtype == "bfloat16" else np.dtype(self.dtype).itemsize

    def packb(self) -> bytes:
        from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

        return MSGPackSerializer.dumps([list(self.shape), self.dtype, self.requires_grad, self.compression])

    @classmethod
    def unpackb(cls, data: bytes) -> "TensorDescriptor":
        from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

        shape, dtype, requires_grad, compression = MSGPackSerializer.loads(data)
        return cls(tuple(shape), dtype, requires_grad, compression)


@dataclasses.dataclass(frozen=True)
class BatchTensorDescriptor(TensorDescriptor):
    """A TensorDescriptor whose leading (batch) dimension is unspecified: shape[0] is
    stored as 0 and means 'any batch size'."""

    @classmethod
    def from_tensor(cls, tensor: Any, compression: Optional[int] = None) -> "BatchTensorDescriptor":
        base = TensorDescriptor.from_tensor(tensor, compression)
        return cls((0, *base.shape[1:]), base.dtype, base.requires_grad, compression)
