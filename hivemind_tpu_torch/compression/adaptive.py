"""Adaptive codec selection (the port of hivemind_tpu/compression/adaptive.py)."""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import torch

from hivemind_tpu_torch.compression.base import CompressionBase, CompressionInfo, TensorRole
from hivemind_tpu_torch.proto import runtime_pb2


class AdaptiveCompressionBase(CompressionBase):
    def choose_compression(self, info: CompressionInfo) -> CompressionBase:
        raise NotImplementedError

    @property
    def compression_type(self):  # type: ignore[override]
        raise AttributeError("adaptive codecs have no fixed compression type")

    def compress(self, tensor: Any, info: Optional[CompressionInfo] = None, allow_inplace: bool = False) -> runtime_pb2.Tensor:
        info = info if info is not None else CompressionInfo.from_tensor(tensor)
        return self.choose_compression(info).compress(tensor, info, allow_inplace)

    def extract(self, serialized: runtime_pb2.Tensor) -> torch.Tensor:
        from hivemind_tpu_torch.compression.serialization import deserialize_tensor

        return deserialize_tensor(serialized)

    def estimate_compression_ratio(self, info: CompressionInfo) -> float:
        return self.choose_compression(info).estimate_compression_ratio(info)


class SizeAdaptiveCompression(AdaptiveCompressionBase):
    """Compress only tensors of at least ``threshold`` elements: small tensors are
    not worth the precision loss."""

    def __init__(self, threshold: int, less: CompressionBase, greater_equal: CompressionBase):
        self.threshold, self.less, self.greater_equal = threshold, less, greater_equal

    def choose_compression(self, info: CompressionInfo) -> CompressionBase:
        numel = info.descriptor.numel if info.descriptor is not None else 0
        return self.greater_equal if numel >= self.threshold else self.less


class RoleAdaptiveCompression(AdaptiveCompressionBase):
    """Pick a codec by the tensor's role in training."""

    def __init__(
        self,
        *,
        activation: Optional[CompressionBase] = None,
        parameter: Optional[CompressionBase] = None,
        gradient: Optional[CompressionBase] = None,
        optimizer: Optional[CompressionBase] = None,
        default: CompressionBase,
    ):
        self.by_role: Mapping[TensorRole, Optional[CompressionBase]] = {
            TensorRole.ACTIVATION: activation,
            TensorRole.PARAMETER: parameter,
            TensorRole.GRADIENT: gradient,
            TensorRole.OPTIMIZER: optimizer,
        }
        self.default = default

    def choose_compression(self, info: CompressionInfo) -> CompressionBase:
        chosen = self.by_role.get(info.role)
        return chosen if chosen is not None else self.default


class PerTensorCompression(AdaptiveCompressionBase):
    """A fixed codec per tensor key (a sequence indexed by position or a mapping)."""

    def __init__(self, tensor_compressions: Sequence[CompressionBase] | Mapping[Any, CompressionBase]):
        self.tensor_compressions = tensor_compressions

    def choose_compression(self, info: CompressionInfo) -> CompressionBase:
        return self.tensor_compressions[info.key]
