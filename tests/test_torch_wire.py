"""PyTorch port vs JAX package: the wire layer, on the CPU. Every codec's
serialized ``runtime_pb2.Tensor`` bytes, the streaming chunks, the request and
response frames, the msgpack serializer and the tensor descriptors must be
IDENTICAL to the JAX package's, and each side must decode the other's bytes to
the same values. The cases mirror tests/test_compression.py,
tests/test_partition_equivalence.py and tests/test_serving_compression.py."""

import asyncio
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import hivemind_tpu.compression as jax_compression
import hivemind_tpu.ops.quantization as jax_quantization
from hivemind_tpu.proto import runtime_pb2 as jax_pb2
from hivemind_tpu.utils.serializer import MSGPackSerializer as JaxMSGPackSerializer
from hivemind_tpu.utils.streaming import split_for_streaming as jax_split_for_streaming
from hivemind_tpu.utils.tensor_descr import BatchTensorDescriptor as JaxBatchTensorDescriptor
from hivemind_tpu.utils.tensor_descr import TensorDescriptor as JaxTensorDescriptor
from hivemind_tpu_torch import compression
from hivemind_tpu_torch.compression import (
    BlockwiseQuantization,
    CompressionInfo,
    CompressionType,
    Float16Compression,
    NoCompression,
    PerTensorCompression,
    Quantile8BitQuantization,
    RoleAdaptiveCompression,
    ScaledFloat16Compression,
    SizeAdaptiveCompression,
    TensorRole,
    Uniform8BitQuantization,
)
from hivemind_tpu_torch.ops import quantization
from hivemind_tpu_torch.proto import runtime_pb2
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.streaming import WireParts, combine_from_streaming, split_for_streaming
from hivemind_tpu_torch.utils.tensor_descr import BatchTensorDescriptor, TensorDescriptor

REPO = Path(__file__).resolve().parent.parent
ALL_CODECS = sorted(runtime_pb2.CompressionType.values())
ALL_CODEC_NAMES = tuple(name.lower() for name in runtime_pb2.CompressionType.keys())
SHAPES = {
    "scalar": (),
    "empty": (0,),
    "odd": (7,),
    "matrix": (3, 5),
    "blocks": (3 * 4096 + 5,),  # several 4096-element blocks and a ragged tail
    "uniform_sample": ((1 << 17) + 1,),  # past the uniform codec's statistics sample
    "quantile_sample": ((1 << 20) + 3,),  # past the quantile codec's codebook sample
}


def _same_data(shape, dtype, seed=0):
    """The same values as a numpy array for the JAX package and a torch tensor for
    the port (bf16: ml_dtypes vs torch, from the same float32 draws)."""
    values = np.asarray(np.random.RandomState(seed).randn(*shape) * 3, np.float32)
    if dtype == "bfloat16":
        return values.astype(ml_dtypes.bfloat16), torch.from_numpy(values).to(torch.bfloat16)
    array = values.astype(dtype)
    return array, torch.from_numpy(array.copy())


def _as_float32(decoded) -> np.ndarray:
    if isinstance(decoded, torch.Tensor):
        return decoded.to(torch.float32).numpy()
    return np.asarray(decoded).astype(np.float32)


def _assert_same_values(ours: torch.Tensor, theirs: np.ndarray, dtype: str) -> None:
    assert isinstance(ours, torch.Tensor) and ours.device.type == "cpu"
    assert ours.dtype == getattr(torch, dtype) and str(theirs.dtype) == dtype
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_array_equal(_as_float32(ours), _as_float32(theirs))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("compression_type", ALL_CODECS, ids=ALL_CODEC_NAMES)
def test_serialized_bytes_match_jax_and_decode_across(compression_type, dtype, shape):
    array, tensor = _same_data(shape, dtype)
    theirs = jax_compression.serialize_tensor(array, compression_type).SerializeToString()
    ours = compression.serialize_tensor(tensor, compression_type).SerializeToString()
    assert ours == theirs
    decoded_here = compression.deserialize_tensor(runtime_pb2.Tensor.FromString(theirs))
    decoded_there = jax_compression.deserialize_tensor(jax_pb2.Tensor.FromString(ours))
    _assert_same_values(decoded_here, decoded_there, dtype)
    assert torch.equal(tensor, _same_data(shape, dtype)[1])  # the input is left as it was


def _equivalence_tensors():
    """tests/test_partition_equivalence.py's mix: values past the fp16 range (the
    clip must fire), float64 (a converting copy) and several shapes."""
    rng = np.random.RandomState(7)
    return [
        rng.randn(1111).astype(np.float32) * 1e5,
        rng.randn(64, 32).astype(np.float32),
        rng.randn(501).astype(np.float64),
        rng.randn(3, 5, 7).astype(np.float32),
    ]


@pytest.mark.parametrize("allow_inplace", [False, True], ids=["copy", "inplace"])
@pytest.mark.parametrize("compression_type", ALL_CODECS, ids=ALL_CODEC_NAMES)
def test_numpy_and_torch_inputs_match_jax(compression_type, allow_inplace):
    for array in _equivalence_tensors():
        expected = jax_compression.serialize_tensor(array.copy(), compression_type).SerializeToString()
        for given in (array.copy(), torch.from_numpy(array.copy())):
            before = given.copy() if isinstance(given, np.ndarray) else given.clone()
            codec = compression.get_codec(compression_type)
            serialized = compression.serialize_tensor(given, codec, allow_inplace=allow_inplace)
            assert serialized.SerializeToString() == expected
            if not allow_inplace:
                np.testing.assert_array_equal(np.asarray(given), np.asarray(before))


@pytest.mark.parametrize(
    "codec,max_rel_error",
    [(NoCompression(), 0.0), (Float16Compression(), 1e-3), (ScaledFloat16Compression(), 1e-3),
     (Uniform8BitQuantization(), 0.1), (Quantile8BitQuantization(), 0.1), (BlockwiseQuantization(), 0.05)],
    ids=ALL_CODEC_NAMES,
)
def test_codec_error_bounds_and_shapes(codec, max_rel_error):
    """tests/test_compression.py's bounds: mean error over mean magnitude."""
    original = torch.from_numpy(np.random.RandomState(42).randn(50_000).astype(np.float32))
    restored = codec.extract(codec.compress(original))
    assert restored.dtype == torch.float32 and restored.shape == original.shape
    assert ((restored - original).abs().mean() / original.abs().mean()).item() <= max_rel_error
    for shape in [(1000,), (32, 71), (2, 3, 5, 7), ()]:
        x = torch.from_numpy(np.asarray(np.random.RandomState(0).randn(*shape), np.float32))
        assert codec.extract(codec.compress(x)).shape == x.shape


@pytest.mark.parametrize("size", [1, 4096, 4099, (1 << 20) + 3], ids=["one", "block", "ragged", "sampled"])
def test_host_codec_helpers_match_jax(size):
    flat = np.random.RandomState(size % 97).randn(size).astype(np.float32)
    for name in ("BLOCKWISE_BLOCK_SIZE", "UNIFORM_NUM_BUCKETS", "UNIFORM_RANGE_IN_SIGMAS", "QUANTILE_SAMPLE_SIZE"):
        assert getattr(quantization, name) == getattr(jax_quantization, name)
    np.testing.assert_array_equal(quantization.hash_sample_indices(size, 1000),
                                  jax_quantization.hash_sample_indices(size, 1000))
    codes, codebook = quantization.quantile_quantize(flat)
    jax_codes, jax_codebook = jax_quantization.quantile_quantize(flat)
    np.testing.assert_array_equal(codes, jax_codes)
    np.testing.assert_array_equal(codebook, jax_codebook)
    np.testing.assert_array_equal(quantization.dequantize_with_codebook(codes, codebook),
                                  jax_quantization.dequantize_with_codebook(jax_codes, jax_codebook))
    edges = np.sort(flat[:255]) if size >= 255 else np.full(255, flat[0])
    np.testing.assert_array_equal(quantization._encode_against_edges(flat, edges), np.searchsorted(edges, flat).astype(np.uint8))
    padded, true_size = quantization.pad_to_block(flat)
    jax_padded, jax_true_size = jax_quantization.pad_to_block(flat)
    np.testing.assert_array_equal(padded, jax_padded)
    assert true_size == jax_true_size == size and padded.size % 4096 == 0


def test_blockwise_keeps_each_blocks_scale():
    rng = np.random.RandomState(0)
    original = np.concatenate([rng.randn(4096) * 1e-4, rng.randn(4096) * 1e2]).astype(np.float32)
    restored = compression.deserialize_tensor(BlockwiseQuantization().compress(torch.from_numpy(original))).numpy()
    assert np.abs(restored[:4096] - original[:4096]).mean() < 1e-5
    assert np.abs(restored[4096:] - original[4096:]).mean() / 1e2 < 0.01


def test_adaptive_codecs_choose_as_the_jax_package():
    rng = np.random.RandomState(3)
    small, large = rng.randn(10).astype(np.float32), rng.randn(2**11).astype(np.float32)
    pairs = [
        (SizeAdaptiveCompression(2**10, NoCompression(), Float16Compression()),
         jax_compression.SizeAdaptiveCompression(2**10, jax_compression.NoCompression(),
                                                 jax_compression.Float16Compression()),
         [dict(), dict()], [small, large]),
        (RoleAdaptiveCompression(gradient=Uniform8BitQuantization(), parameter=Float16Compression(),
                                 default=NoCompression()),
         jax_compression.RoleAdaptiveCompression(gradient=jax_compression.Uniform8BitQuantization(),
                                                 parameter=jax_compression.Float16Compression(),
                                                 default=jax_compression.NoCompression()),
         [dict(role=role) for role in ("GRADIENT", "PARAMETER", "ACTIVATION")], [large] * 3),
        (PerTensorCompression({"a": NoCompression(), "b": BlockwiseQuantization()}),
         jax_compression.PerTensorCompression({"a": jax_compression.NoCompression(),
                                               "b": jax_compression.BlockwiseQuantization()}),
         [dict(key="a"), dict(key="b")], [large, large]),
    ]
    chosen = []
    for ours, theirs, infos, arrays in pairs:
        for info, array in zip(infos, arrays):
            role = info.get("role")
            our_info = CompressionInfo.from_tensor(torch.from_numpy(array), key=info.get("key"),
                                                   role=TensorRole[role] if role else TensorRole.UNSPECIFIED)
            their_info = jax_compression.CompressionInfo.from_array(
                array, key=info.get("key"),
                role=jax_compression.TensorRole[role] if role else jax_compression.TensorRole.UNSPECIFIED)
            message = ours.compress(torch.from_numpy(array), our_info)
            assert message.SerializeToString() == theirs.compress(array, their_info).SerializeToString()
            assert ours.estimate_compression_ratio(our_info) == theirs.estimate_compression_ratio(their_info)
            chosen.append(message.compression)
            assert ours.extract(message).shape == array.shape
    assert chosen == [CompressionType.NONE, CompressionType.FLOAT16, CompressionType.UNIFORM_8BIT,
                      CompressionType.FLOAT16, CompressionType.NONE, CompressionType.NONE, CompressionType.BLOCKWISE_8BIT]


# ------------------------------------------------------------------ streaming and frames


@pytest.mark.parametrize("compression_type", ALL_CODECS, ids=ALL_CODEC_NAMES)
def test_streaming_chunks_match_jax_and_reassemble(compression_type):
    rng = np.random.RandomState(5)
    originals = [rng.randn(100_000).astype(np.float32), rng.randn(10).astype(np.float32),
                 rng.randn(333, 3).astype(np.float32), np.zeros(0, np.float32)]
    chunks = []
    for original in originals:
        ours = compression.split_tensor_for_streaming(
            compression.serialize_tensor(torch.from_numpy(original), compression_type), 2**16)
        theirs = jax_compression.split_tensor_for_streaming(
            jax_compression.serialize_tensor(original, compression_type), 2**16)
        assert [c.SerializeToString() for c in ours] == [c.SerializeToString() for c in theirs]
        chunks.extend(ours)
    first_tensor_chunks = chunks[0].chunks
    assert first_tensor_chunks > 1

    async def stream(parts):
        for chunk in parts:
            yield [chunk]

    for off_loop in (False, True):
        restored = asyncio.run(compression.deserialize_tensor_stream(stream(chunks), off_loop=off_loop))
        assert len(restored) == len(originals)
        for original, tensor in zip(originals, restored):
            expected = compression.deserialize_tensor(compression.serialize_tensor(torch.from_numpy(original),
                                                                                   compression_type))
            assert torch.equal(tensor, expected)
    with pytest.raises(ValueError, match="mid-tensor"):
        asyncio.run(compression.deserialize_tensor_stream(stream(chunks[: first_tensor_chunks - 1])))


def test_split_for_streaming_matches_jax():
    for data in (b"", b"x", bytes(range(256)) * 700):
        ours = list(split_for_streaming(data, 1000))
        assert ours == list(jax_split_for_streaming(data, 1000))
        assert combine_from_streaming(ours) == data
    assert WireParts(b"ab", b"", memoryview(b"cd")).join() == b"abcd" and len(WireParts(b"ab", b"c")) == 3


@pytest.mark.parametrize("name", ALL_CODEC_NAMES)
def test_request_and_response_frames_match_jax_and_protobuf(name):
    rng = np.random.RandomState(0)
    codec, jax_codec = compression.resolve_activation_codec(name), jax_compression.resolve_activation_codec(name)
    assert compression.codec_name(codec) == jax_compression.codec_name(jax_codec) == name
    for array in (rng.randn(3, 5).astype(np.float32), rng.randn(70000).astype(np.float32),
                  np.array([], np.float32), np.asarray(np.float32(2.25))):
        tensor = compression.serialize_tensor(torch.from_numpy(array), codec)
        jax_tensor = jax_compression.serialize_tensor(array, jax_codec)
        request = runtime_pb2.ExpertRequest(uid="eq.0", tensors=[tensor, tensor], metadata=b"\x00meta")
        frames = [
            (compression.expert_request_parts("eq.0", [tensor, tensor], b"\x00meta"),
             jax_compression.expert_request_parts("eq.0", [jax_tensor, jax_tensor], b"\x00meta"),
             request.SerializeToString()),
            (compression.expert_request_parts("", [tensor]), jax_compression.expert_request_parts("", [jax_tensor]),
             runtime_pb2.ExpertRequest(tensors=[tensor]).SerializeToString()),
            (compression.expert_response_parts([tensor], b"m"), jax_compression.expert_response_parts([jax_tensor], b"m"),
             runtime_pb2.ExpertResponse(tensors=[tensor], metadata=b"m").SerializeToString()),
        ]
        for ours, theirs, protobuf in frames:
            assert ours.join() == theirs.join() == protobuf
        assert jax_pb2.ExpertRequest.FromString(request.SerializeToString()).uid == "eq.0"
        ours = [w.join() for w in compression.split_response_for_wire(tensor, 1024)]
        assert ours == [w.join() for w in jax_compression.split_response_for_wire(jax_tensor, 1024)]
        assert ours == [runtime_pb2.ExpertResponse(tensors=[chunk]).SerializeToString()
                        for chunk in compression.split_tensor_for_streaming(tensor, 1024)]


def test_resolve_activation_codec_knob():
    assert compression.resolve_activation_codec(None).compression_type == CompressionType.NONE
    assert compression.resolve_activation_codec("FLOAT16") is compression.get_codec(CompressionType.FLOAT16)
    with pytest.raises(ValueError, match="unknown activation compression"):
        compression.resolve_activation_codec("bogus")


# ------------------------------------------------------------------ msgpack and descriptors


def test_msgpack_serializer_matches_jax_with_tuples_and_ext_types():
    ours = [TensorDescriptor((2, 3), "bfloat16", False, CompressionType.FLOAT16), BatchTensorDescriptor((0, 64, 8))]
    theirs = [JaxTensorDescriptor((2, 3), "bfloat16", False, CompressionType.FLOAT16), JaxBatchTensorDescriptor((0, 64, 8))]
    values = [
        (1, "a", b"\x00"),
        {"nested": [(1, (2.5, None)), {"k": (True,)}], "x": -3},
        [],
    ]
    for value in values:
        packed = MSGPackSerializer.dumps(value)
        assert packed == JaxMSGPackSerializer.dumps(value)
        assert MSGPackSerializer.loads(packed) == value
    packed = MSGPackSerializer.dumps({"schema": (ours[0], [ours[1]])})
    assert packed == JaxMSGPackSerializer.dumps({"schema": (theirs[0], [theirs[1]])})
    loaded = MSGPackSerializer.loads(JaxMSGPackSerializer.dumps({"schema": (theirs[0], [theirs[1]])}))
    assert loaded == {"schema": (ours[0], [ours[1]])} and type(loaded["schema"][1][0]) is BatchTensorDescriptor
    for descriptor, jax_descriptor in zip(ours, theirs):
        assert descriptor.packb() == jax_descriptor.packb()
        assert type(descriptor).unpackb(jax_descriptor.packb()) == descriptor
    with pytest.raises(TypeError, match="cannot serialize"):
        MSGPackSerializer.dumps(object())


_BOTH_PB2 = """
import importlib, sys
first, second = sys.argv[1:]
modules = [importlib.import_module(name) for name in (first, second)]
names = {module.DESCRIPTOR.package for module in modules}
assert names == {"hivemind_tpu", "hivemind_tpu_torch"}, names
tensors = [module.Tensor(buffer=b"ab", size=[1, 2], dtype="float16", compression=module.FLOAT16) for module in modules]
assert tensors[0].SerializeToString() == tensors[1].SerializeToString()
print("both")
"""


@pytest.mark.parametrize("order", ["port_first", "jax_first"])
def test_both_runtime_pb2_modules_load_in_one_process(order):
    names = ["hivemind_tpu_torch.proto.runtime_pb2", "hivemind_tpu.proto.runtime_pb2"]
    if order == "jax_first":
        names.reverse()
    result = subprocess.run([sys.executable, "-c", _BOTH_PB2, *names], cwd=REPO, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "both"
    assert dict(runtime_pb2.CompressionType.items()) == dict(jax_pb2.CompressionType.items())
