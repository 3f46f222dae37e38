"""The port's own codecs against the libraries the JAX package uses, byte for byte
in both directions: its msgpack subset against ``msgpack``, its MSGPackSerializer
against the JAX package's, every ``runtime.proto`` message against the generated
``hivemind_tpu.proto.runtime_pb2`` (unknown fields, unpacked repeated input and
default values included, and the field tables of both schemas against the
generated descriptors), ``dht.proto``'s doubles and singular messages against
``hivemind_tpu.proto.dht_pb2``, and its libcrypto shim against ``cryptography`` for the same keys
and nonces, PeerID included."""

from __future__ import annotations

import enum
import struct

import msgpack
import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import ed25519, x25519
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives.kdf.hkdf import HKDF
from google.protobuf.descriptor import FieldDescriptor
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hivemind_tpu.p2p.peer_id import PeerID as JaxPeerID
from hivemind_tpu.proto import dht_pb2 as jax_dht_pb2
from hivemind_tpu.proto import runtime_pb2 as jax_pb2
from hivemind_tpu.utils.crypto import Ed25519PrivateKey as JaxEd25519PrivateKey
from hivemind_tpu.utils.serializer import MSGPackSerializer as JaxMSGPackSerializer
from hivemind_tpu.utils.tensor_descr import BatchTensorDescriptor as JaxBatchTensorDescriptor
from hivemind_tpu_torch.p2p import P2P
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.proto import dht_pb2, runtime_pb2, wire
from hivemind_tpu_torch.utils import _libcrypto, msgpack_codec
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.tensor_descr import BatchTensorDescriptor

SETTINGS = settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def their_packb(value, default=None) -> bytes:
    return msgpack.packb(value, use_bin_type=True, strict_types=True, default=default)


def their_unpackb(data, ext_hook=None):
    kwargs = {} if ext_hook is None else {"ext_hook": ext_hook}
    return msgpack.unpackb(data, raw=False, strict_map_key=False, **kwargs)


# ------------------------------------------------------------------ msgpack

INT_EDGES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1,
             -1, -31, -32, -33, -127, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)]
LENGTH_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]

scalars = (st.none() | st.booleans() | st.sampled_from(INT_EDGES)
           | st.integers(min_value=-(2**63), max_value=2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
values = st.recursive(
    scalars,
    lambda children: st.lists(children, max_size=20)
    | st.dictionaries(st.text(max_size=8) | st.integers(-1000, 1000), children, max_size=20),
    max_leaves=40,
)


@SETTINGS
@given(values)
def test_msgpack_values_are_byte_identical_both_ways(value):
    packed = msgpack_codec.packb(value)
    assert packed == their_packb(value)
    assert msgpack_codec.unpackb(packed) == their_unpackb(packed) == value


@pytest.mark.parametrize("length", LENGTH_EDGES)
def test_msgpack_length_edges_of_str_bin_array_map_ext(length):
    for value in ("a" * length, b"b" * length, bytearray(b"c" * length), memoryview(b"d" * length),
                  [1] * length, {i: None for i in range(length)}):
        assert msgpack_codec.packb(value) == their_packb(value)
        assert msgpack_codec.unpackb(their_packb(value)) == their_unpackb(their_packb(value))
    ext = msgpack_codec.packb(msgpack_codec.ExtType(5, b"e" * length))  # fixext where the length fits
    assert ext == their_packb(msgpack.ExtType(5, b"e" * length))
    assert tuple(msgpack_codec.unpackb(ext)) == (5, b"e" * length)


def test_msgpack_strict_types_send_subclasses_and_tuples_to_default():
    class Level(enum.IntEnum):
        HIGH = 3

    class Fraction(float):
        pass

    def default(obj):
        return ["default", type(obj).__name__, list(obj) if isinstance(obj, tuple) else repr(obj)]

    for value in [(1, 2), Level.HIGH, Fraction(0.5), {"nested": [(3,), Level.HIGH]}, np.float32(1.0)]:
        assert msgpack_codec.packb(value, default=default) == their_packb(value, default=default)
    for value in [(1, 2), Level.HIGH, object()]:
        with pytest.raises(TypeError):
            msgpack_codec.packb(value)
        with pytest.raises(TypeError):
            their_packb(value)


def test_msgpack_integer_range_and_malformed_input():
    for value in (2**64, -(2**63) - 1):
        with pytest.raises(OverflowError):
            msgpack_codec.packb(value)
        with pytest.raises(OverflowError):
            their_packb(value)
        assert msgpack_codec.packb(value, default=str) == their_packb(value, default=str)
    for data in (b"\x91", b"\xd9\x05ab", b"\x01\x02", b"\xc1", b"\xa1\xff", b"\xcd\x01"):
        with pytest.raises(ValueError) as ours:
            msgpack_codec.unpackb(data)
        with pytest.raises(ValueError) as theirs:
            their_unpackb(data)
        assert type(ours.value).__name__ == type(theirs.value).__name__ or isinstance(ours.value, UnicodeError)


def test_msgpack_reads_memoryviews_and_large_bins_in_one_slice():
    blob = np.random.default_rng(0).bytes(3 << 20)
    packed = their_packb({"blob": blob, "n": 1})
    assert msgpack_codec.unpackb(memoryview(packed)) == {"blob": blob, "n": 1}
    assert msgpack_codec.unpackb(bytearray(packed))["blob"] == blob
    # a non-byte memoryview is read as its bytes, as msgpack reads it
    array = np.arange(6, dtype=np.float32)
    assert msgpack_codec.packb(memoryview(array)) == their_packb(memoryview(array))


ext_payloads = st.recursive(
    st.integers(-(2**40), 2**40) | st.text(max_size=10) | st.binary(max_size=20) | st.none(),
    lambda children: st.lists(children, max_size=5).map(tuple) | st.lists(children, max_size=5)
    | st.dictionaries(st.text(max_size=5), children, max_size=5),
    max_leaves=20,
)


@SETTINGS
@given(ext_payloads)
def test_msgpack_serializer_matches_jax_with_tuples(value):
    packed = MSGPackSerializer.dumps(value)
    assert packed == JaxMSGPackSerializer.dumps(value)
    assert MSGPackSerializer.loads(packed) == JaxMSGPackSerializer.loads(packed) == value


def test_msgpack_serializer_matches_jax_with_registered_ext_classes():
    ours = BatchTensorDescriptor(shape=(0, 64), dtype="bfloat16")
    theirs = JaxBatchTensorDescriptor(shape=(0, 64), dtype="bfloat16")
    value = {"schema": (ours, [ours]), "info": ("x", 1)}
    packed = MSGPackSerializer.dumps(value)
    assert packed == JaxMSGPackSerializer.dumps({"schema": (theirs, [theirs]), "info": ("x", 1)})
    loaded = MSGPackSerializer.loads(packed)
    assert loaded == value and type(loaded["schema"][1][0]) is BatchTensorDescriptor


# ------------------------------------------------------------------ runtime.proto

uint32s = st.integers(0, 2**32 - 1)
tensor_fields = st.fixed_dictionaries({}, optional={
    "buffer": st.binary(max_size=5000),
    "size": st.lists(uint32s, max_size=6),
    "dtype": st.text(max_size=12),
    "requires_grad": st.booleans(),
    "compression": st.sampled_from(sorted(runtime_pb2.CompressionType.values())),
    "chunks": uint32s,
})
MESSAGES = ("Tensor", "ExpertUID", "ExpertRequest", "ExpertResponse", "ExpertInfoResponse")


@st.composite
def message_fields(draw, name):
    if name == "Tensor":
        return draw(tensor_fields)
    if name == "ExpertUID":
        return draw(st.fixed_dictionaries({}, optional={"uid": st.text(max_size=20)}))
    if name == "ExpertInfoResponse":
        return draw(st.fixed_dictionaries({}, optional={"serialized_info": st.binary(max_size=200)}))
    fields = draw(st.fixed_dictionaries({}, optional={"tensors": st.lists(tensor_fields, max_size=3),
                                                      "metadata": st.binary(max_size=50)}))
    if name == "ExpertRequest":
        fields.update(draw(st.fixed_dictionaries({}, optional={"uid": st.text(max_size=20)})))
    return fields


def build(module, name, fields):
    fields = dict(fields)
    if "tensors" in fields:
        fields["tensors"] = [module.Tensor(**tensor) for tensor in fields["tensors"]]
    return getattr(module, name)(**fields)


@pytest.mark.parametrize("name", MESSAGES)
@SETTINGS
@given(data=st.data())
def test_every_message_is_byte_identical_both_ways(name, data):
    fields = data.draw(message_fields(name))
    ours, theirs = build(runtime_pb2, name, fields), build(jax_pb2, name, fields)
    encoded = theirs.SerializeToString()
    assert ours.SerializeToString() == encoded
    assert ours.ByteSize() == theirs.ByteSize() == len(encoded)
    parsed = getattr(runtime_pb2, name).FromString(encoded)
    assert parsed == ours and parsed.SerializeToString() == encoded
    assert getattr(jax_pb2, name).FromString(ours.SerializeToString()) == theirs
    copy = getattr(runtime_pb2, name)()
    copy.CopyFrom(parsed)
    assert copy == ours


def _unknown_fields() -> bytes:
    tag = lambda number, wire_type: wire.encode_tag(number, wire_type)  # noqa: E731
    return b"".join([
        tag(15, wire.VARINT), wire.encode_varint(2**63 + 5),
        tag(16, wire.FIXED64), struct.pack("<d", 1.5),
        tag(17, wire.LENGTH_DELIMITED), wire.encode_varint(3), b"abc",
        tag(18, wire.FIXED32), struct.pack("<f", 2.5),
        tag(19, wire.START_GROUP), tag(1, wire.VARINT), b"\x07", tag(19, wire.END_GROUP),
    ])


def test_parser_skips_unknown_fields_of_every_wire_type():
    theirs = jax_pb2.ExpertRequest(uid="x.0", tensors=[jax_pb2.Tensor(size=[2, 3], dtype="float32")],
                                   metadata=b"m")
    noisy = _unknown_fields() + theirs.SerializeToString() + _unknown_fields()
    parsed_theirs = jax_pb2.ExpertRequest.FromString(noisy)
    parsed_theirs.DiscardUnknownFields()
    ours = runtime_pb2.ExpertRequest.FromString(noisy)
    assert ours.SerializeToString() == parsed_theirs.SerializeToString() == theirs.SerializeToString()


def test_parser_takes_unpacked_repeated_scalars_and_the_last_scalar_value():
    unpacked_size = b"".join(wire.encode_tag(2, wire.VARINT) + wire.encode_varint(v) for v in (1, 300, 2**32 - 1))
    repeated_scalars = (wire.encode_tag(6, wire.VARINT) + b"\x05" + wire.encode_tag(6, wire.VARINT) + b"\x09"
                        + wire.encode_tag(3, wire.LENGTH_DELIMITED) + b"\x01a"
                        + wire.encode_tag(3, wire.LENGTH_DELIMITED) + b"\x02bf")
    data = unpacked_size + repeated_scalars + wire.encode_tag(2, wire.LENGTH_DELIMITED) + b"\x01\x04"
    ours, theirs = runtime_pb2.Tensor.FromString(data), jax_pb2.Tensor.FromString(data)
    assert list(ours.size) == list(theirs.size) == [1, 300, 2**32 - 1, 4]
    assert ours.chunks == theirs.chunks == 9 and ours.dtype == theirs.dtype == "bf"
    assert ours.SerializeToString() == theirs.SerializeToString()


def test_default_values_are_left_out():
    for module in (runtime_pb2, jax_pb2):
        empty = module.Tensor(buffer=b"", size=[], dtype="", requires_grad=False, compression=0, chunks=0)
        assert empty.SerializeToString() == b""
        assert module.ExpertRequest(uid="", tensors=[], metadata=b"").SerializeToString() == b""
    assert runtime_pb2.ExpertResponse(tensors=[runtime_pb2.Tensor()]).SerializeToString() == b"\x0a\x00"


def test_bytes_fields_take_memoryviews_and_parse_into_views_without_a_copy():
    buffer = memoryview(np.random.default_rng(1).bytes(1 << 20))
    tensor = runtime_pb2.Tensor(buffer=buffer, size=[1 << 18], dtype="float32")
    assert tensor.buffer is buffer
    encoded = tensor.SerializeToString()
    assert encoded == jax_pb2.Tensor(buffer=bytes(buffer), size=[1 << 18], dtype="float32").SerializeToString()
    parsed = runtime_pb2.Tensor.FromString(encoded)
    assert isinstance(parsed.buffer, memoryview) and parsed.buffer.obj is encoded and parsed.buffer == buffer


def test_malformed_messages_raise_decode_errors():
    for data in (b"\x0a\x05ab", b"\x10", b"\x00\x01", b"\x1a\x02\xff\xfe", b"\x0b\x01"):
        with pytest.raises(wire.DecodeError):
            runtime_pb2.Tensor.FromString(data)


_PROTO_TYPES = {wire.BYTES: FieldDescriptor.TYPE_BYTES, wire.UINT32: FieldDescriptor.TYPE_UINT32,
                wire.STRING: FieldDescriptor.TYPE_STRING, wire.BOOL: FieldDescriptor.TYPE_BOOL,
                wire.ENUM: FieldDescriptor.TYPE_ENUM, wire.MESSAGE: FieldDescriptor.TYPE_MESSAGE,
                wire.DOUBLE: FieldDescriptor.TYPE_DOUBLE}
DHT_MESSAGES = tuple(jax_dht_pb2.DESCRIPTOR.message_types_by_name)


def _is_repeated(field: FieldDescriptor) -> bool:
    if hasattr(field, "is_repeated"):  # protobuf >= 6 deprecates ``label``
        return field.is_repeated
    return field.label == FieldDescriptor.LABEL_REPEATED


@pytest.mark.parametrize("name", MESSAGES + DHT_MESSAGES)
def test_field_tables_match_the_generated_descriptors(name):
    ours_module, theirs_module, enum_name = ((runtime_pb2, jax_pb2, "CompressionType") if name in MESSAGES
                                             else (dht_pb2, jax_dht_pb2, "ResultType"))
    descriptor = theirs_module.DESCRIPTOR.message_types_by_name[name]
    theirs = [(f.name, f.number, f.type, _is_repeated(f),
               f.message_type.name if f.message_type else None, f.enum_type.name if f.enum_type else None)
              for f in descriptor.fields]
    ours = [(f.name, f.number, _PROTO_TYPES[f.type], f.repeated,
             f.message_type.__name__ if f.message_type else None, f.enum_type.name if f.enum_type else None)
            for f in ours_module.DESCRIPTOR.message_types_by_name[name].FIELDS]
    assert ours == theirs
    assert set(ours_module.DESCRIPTOR.message_types_by_name) == set(theirs_module.DESCRIPTOR.message_types_by_name)
    enum_type = theirs_module.DESCRIPTOR.enum_types_by_name[enum_name]
    assert getattr(ours_module, enum_name).items() == [(v.name, v.number) for v in enum_type.values]


# ------------------------------------------------------------------ doubles and singular messages

any_double = st.floats() | st.sampled_from([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 5e-324])


@SETTINGS
@given(single=any_double, repeated=st.lists(any_double, max_size=6))
def test_doubles_are_protobufs_bytes_both_ways(single, repeated):
    ours = dht_pb2.FindResult(expiration_time=single)
    theirs = jax_dht_pb2.FindResult(expiration_time=single)
    assert ours.SerializeToString() == theirs.SerializeToString()  # 0.0 left out, -0.0 and nan written
    ours_list = dht_pb2.StoreRequest(expiration_time=repeated)
    theirs_list = jax_dht_pb2.StoreRequest(expiration_time=repeated)
    encoded = theirs_list.SerializeToString()
    assert ours_list.SerializeToString() == encoded and ours_list.ByteSize() == len(encoded)  # packed
    parsed = dht_pb2.StoreRequest.FromString(encoded)
    assert [struct.pack("<d", v) for v in parsed.expiration_time] == [struct.pack("<d", v) for v in repeated]
    back = jax_dht_pb2.FindResult.FromString(ours.SerializeToString()).expiration_time
    assert struct.pack("<d", back) == struct.pack("<d", single)


def test_unpacked_doubles_parse_and_truncated_ones_raise():
    unpacked = b"".join(wire.encode_tag(4, wire.FIXED64) + struct.pack("<d", v) for v in (1.5, -2.25))
    packed = wire.encode_tag(4, wire.LENGTH_DELIMITED) + b"\x08" + struct.pack("<d", 8.0)
    ours, theirs = dht_pb2.StoreRequest.FromString(unpacked + packed), jax_dht_pb2.StoreRequest.FromString(unpacked + packed)
    assert list(ours.expiration_time) == list(theirs.expiration_time) == [1.5, -2.25, 8.0]
    assert ours.SerializeToString() == theirs.SerializeToString()
    with pytest.raises(wire.DecodeError):
        dht_pb2.PingResponse.FromString(wire.encode_tag(2, wire.FIXED64) + b"\x00" * 7)
    with pytest.raises(wire.DecodeError):
        dht_pb2.StoreRequest.FromString(wire.encode_tag(4, wire.LENGTH_DELIMITED) + b"\x05" + b"\x00" * 5)


def test_singular_messages_have_presence_merge_and_copy_as_in_protobuf():
    first = jax_dht_pb2.NodeInfo(node_id=b"a", maddrs=["x"]).SerializeToString()
    second = jax_dht_pb2.NodeInfo(maddrs=["y"], auth_token=b"t").SerializeToString()
    tag = wire.encode_tag(1, wire.LENGTH_DELIMITED)
    data = tag + wire.encode_varint(len(first)) + first + tag + wire.encode_varint(len(second)) + second
    ours, theirs = dht_pb2.PingRequest.FromString(data), jax_dht_pb2.PingRequest.FromString(data)
    assert (ours.peer.node_id, list(ours.peer.maddrs), ours.peer.auth_token) == (b"a", ["x", "y"], b"t")
    assert ours.SerializeToString() == theirs.SerializeToString()
    copy = dht_pb2.PingRequest()
    copy.CopyFrom(ours)
    assert copy == ours and copy.peer is not ours.peer and copy.HasField("peer")
    copy.CopyFrom(dht_pb2.PingRequest(validate=True))
    assert not copy.HasField("peer") and copy.SerializeToString() == b"\x10\x01"
    nested = dht_pb2.FindResponse()
    nested.results.add().nearest_contacts.add(peer_id=b"p")
    nested.peer.auth_token = b"k"
    theirs_nested = jax_dht_pb2.FindResponse()
    theirs_nested.results.add().nearest_contacts.add(peer_id=b"p")
    theirs_nested.peer.auth_token = b"k"
    assert nested.SerializeToString() == theirs_nested.SerializeToString()
    with pytest.raises(TypeError):
        dht_pb2.PingRequest(peer=dht_pb2.PeerContact())


# ------------------------------------------------------------------ crypto

keys = st.binary(min_size=32, max_size=32)
CRYPTO_SETTINGS = settings(max_examples=25, deadline=None)


@CRYPTO_SETTINGS
@given(seed=keys, message=st.binary(max_size=500))
def test_ed25519_signs_and_verifies_across_and_gives_the_same_peer_id(seed, message):
    ours, theirs = _libcrypto.Ed25519PrivateKey.from_private_bytes(seed), ed25519.Ed25519PrivateKey.from_private_bytes(seed)
    assert ours.sign(message) == theirs.sign(message)  # Ed25519 is deterministic
    assert ours.public_key().public_bytes_raw() == theirs.public_key().public_bytes_raw()
    wrapped, jax_wrapped = Ed25519PrivateKey.from_bytes(seed), JaxEd25519PrivateKey.from_bytes(seed)
    assert wrapped.to_bytes() == jax_wrapped.to_bytes() == seed
    assert wrapped.get_public_key().verify(message, jax_wrapped.sign(message))
    assert jax_wrapped.get_public_key().verify(message, wrapped.sign(message))
    assert not wrapped.get_public_key().verify(message + b"!", jax_wrapped.sign(message))
    peer, jax_peer = PeerID.from_private_key(wrapped), JaxPeerID.from_private_key(jax_wrapped)
    assert peer.to_bytes() == jax_peer.to_bytes() and peer.to_base58() == jax_peer.to_base58()
    assert PeerID.from_base58(jax_peer.to_base58()) == peer


@CRYPTO_SETTINGS
@given(ours_seed=keys, theirs_seed=keys)
def test_x25519_agrees_with_cryptography(ours_seed, theirs_seed):
    ours = _libcrypto.X25519PrivateKey.from_private_bytes(ours_seed)
    theirs = x25519.X25519PrivateKey.from_private_bytes(theirs_seed)
    shared = ours.exchange(_libcrypto.X25519PublicKey.from_public_bytes(theirs.public_key().public_bytes_raw()))
    assert shared == theirs.exchange(x25519.X25519PublicKey.from_public_bytes(ours.public_key().public_bytes_raw()))


@CRYPTO_SETTINGS
@given(key=keys, nonce=st.binary(min_size=12, max_size=12), data=st.binary(max_size=3000),
       cuts=st.lists(st.integers(0, 3000), max_size=4))
def test_chacha20_poly1305_agrees_with_cryptography(key, nonce, data, cuts):
    theirs = ChaCha20Poly1305(key)
    bounds = [0, *sorted(min(c, len(data)) for c in cuts), len(data)]
    parts = [memoryview(data)[a:b] for a, b in zip(bounds, bounds[1:])]
    sealed = _libcrypto.ChaCha20Poly1305(key).encrypt_parts(nonce, parts)
    assert bytes(sealed) == theirs.encrypt(nonce, data, None)
    assert _libcrypto.ChaCha20Poly1305(key).decrypt(nonce, theirs.encrypt(nonce, data, None)) == data
    tampered = bytearray(sealed)
    tampered[-1] ^= 1
    with pytest.raises(_libcrypto.InvalidTag):
        _libcrypto.ChaCha20Poly1305(key).decrypt(nonce, tampered)


@CRYPTO_SETTINGS
@given(material=st.binary(min_size=1, max_size=64), salt=st.binary(min_size=1, max_size=40),
       info=st.binary(max_size=40), length=st.integers(1, 200))
def test_hkdf_agrees_with_cryptography(material, salt, info, length):
    expected = HKDF(algorithm=hashes.SHA256(), length=length, salt=salt, info=info).derive(material)
    assert _libcrypto.hkdf_sha256(material, length, salt=salt, info=info) == expected


async def test_without_libcrypto_every_handshake_raises_naming_the_library(monkeypatch):
    monkeypatch.setattr(_libcrypto, "_lib", None)
    monkeypatch.setattr(_libcrypto.ctypes, "CDLL", lambda name: (_ for _ in ()).throw(OSError(f"no {name}")))
    with pytest.raises(_libcrypto.LibcryptoUnavailable, match="libcrypto"):
        await P2P.create()
