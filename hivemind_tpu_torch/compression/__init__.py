"""The wire layer's tensor codecs (the port of hivemind_tpu/compression/): torch
tensors or numpy arrays to ``runtime_pb2.Tensor`` messages and back, byte for byte
as the JAX package writes them, on the port's own proto3 codec."""

from hivemind_tpu_torch.compression.adaptive import (
    PerTensorCompression,
    RoleAdaptiveCompression,
    SizeAdaptiveCompression,
)
from hivemind_tpu_torch.compression.base import (
    CompressionBase,
    CompressionInfo,
    CompressionType,
    NoCompression,
    TensorRole,
)
from hivemind_tpu_torch.compression.floating import Float16Compression, ScaledFloat16Compression
from hivemind_tpu_torch.compression.quantization import (
    BlockwiseQuantization,
    Quantile8BitQuantization,
    Uniform8BitQuantization,
)
from hivemind_tpu_torch.compression.serialization import (
    codec_name,
    deserialize_tensor,
    deserialize_tensor_stream,
    expert_request_parts,
    expert_response_parts,
    get_codec,
    resolve_activation_codec,
    serialize_tensor,
    split_response_for_wire,
    split_tensor_for_streaming,
)
