"""Compression framework (the port of hivemind_tpu/compression/base.py).

Codecs turn tensors into ``runtime_pb2.Tensor`` messages and back. They take
torch tensors (on any device: a CUDA tensor is copied to the host first) and
numpy arrays, and ``extract`` returns a CPU torch tensor. The arithmetic runs in
numpy on the host, as in the JAX package, so both packages write the same bytes.
bfloat16 is first-class without ml_dtypes: its bytes come from the tensor's
int16 view, its values from a float32 widening (exact), and a decoded bf16
tensor is rounded from float32 by torch (to nearest even, as ml_dtypes rounds).
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, Optional

import numpy as np
import torch

from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.utils.tensor_descr import TensorDescriptor, canonical_dtype_name

CompressionType = runtime_pb2.CompressionType


class TensorRole(Enum):
    ACTIVATION = "activation"
    PARAMETER = "parameter"
    GRADIENT = "gradient"
    OPTIMIZER = "optimizer"
    UNSPECIFIED = "unspecified"


@dataclasses.dataclass(frozen=True)
class CompressionInfo:
    """Metadata a codec may use to decide how to compress."""

    key: Any = None
    descriptor: Optional[TensorDescriptor] = None
    role: TensorRole = TensorRole.UNSPECIFIED
    part_index: int = 0
    part_size: Optional[int] = None

    @classmethod
    def from_tensor(cls, tensor: Any, key: Any = None, role: TensorRole = TensorRole.UNSPECIFIED) -> "CompressionInfo":
        return cls(key=key, descriptor=TensorDescriptor.from_tensor(tensor), role=role)


def dtype_name(tensor: Any) -> str:
    """The numpy name of a tensor's or an array's dtype ("float32", "bfloat16", ...)."""
    return canonical_dtype_name(tensor.dtype)


def _host(tensor: Any) -> Any:
    """A torch tensor, detached and on the CPU, or a numpy array as it is."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().to("cpu")
    return np.asarray(tensor)


def raw_bytes(tensor: Any) -> bytes:
    """The tensor's elements as little-endian bytes, in row-major order."""
    tensor = _host(tensor)
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.contiguous()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.view(torch.int16)
        tensor = tensor.numpy()
    return tensor.tobytes()


def as_float32(tensor: Any) -> np.ndarray:
    """The tensor's values as a float32 numpy array (a view where it already is one)."""
    tensor = _host(tensor)
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.to(torch.float32).numpy()
    return tensor.astype(np.float32, copy=False)


def from_float32(values: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """Decoded float32 values as a CPU tensor of ``dtype`` and ``shape``."""
    values = np.asarray(values, np.float32).reshape(tuple(shape))
    if dtype != "bfloat16":
        values = values.astype(np.dtype(dtype), copy=False)
    if not (values.flags.writeable and values.flags.c_contiguous):  # e.g. a view of the message's bytes
        values = values.copy()
    tensor = torch.from_numpy(values)
    return tensor.to(torch.bfloat16) if dtype == "bfloat16" else tensor


class CompressionBase(ABC):
    compression_type: int = CompressionType.NONE
    # True when extract(compress(x)) != x in general
    is_lossy: bool = False

    @abstractmethod
    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        """Encode a tensor into a protobuf Tensor."""

    @abstractmethod
    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        """Decode a protobuf Tensor back into a CPU tensor."""

    def estimate_compression_ratio(self, info: CompressionInfo) -> float:
        """compressed size / original size (approximate)."""
        return 1.0

    def __repr__(self):
        return f"{type(self).__name__}()"


class NoCompression(CompressionBase):
    """Raw little-endian bytes; bfloat16 serialized natively."""

    compression_type = CompressionType.NONE

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        return runtime_pb2.Tensor(
            buffer=raw_bytes(tensor),
            size=tensor.shape,
            dtype=dtype_name(tensor),
            requires_grad=bool(getattr(tensor, "requires_grad", False)),
            compression=self.compression_type,
        )

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        shape = tuple(serialized.size)
        if serialized.dtype == "bfloat16":
            bits = np.frombuffer(serialized.buffer, dtype=np.int16).reshape(shape).copy()
            return torch.from_numpy(bits).view(torch.bfloat16)
        array = np.frombuffer(serialized.buffer, dtype=np.dtype(serialized.dtype)).reshape(shape)
        return torch.from_numpy(array.copy())
