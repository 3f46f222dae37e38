"""The messages of the JAX package's ``test.proto`` (the echo messages of the relay,
NAT and transport tests), declared by their field tables on the port's own proto3
codec (``proto/wire.py``): the same names, field numbers and types, so the wire
bytes are protobuf's."""

from hivemind_tpu_torch.proto.wire import INT64, Field, FileSchema, Message


class TestRequest(Message):
    FIELDS = (Field("number", 1, INT64),)


class TestResponse(Message):
    FIELDS = (Field("number", 1, INT64),)


DESCRIPTOR = FileSchema(
    name="hivemind_tpu_torch/proto/test.proto",
    package="hivemind_tpu_torch",
    message_types_by_name={cls.__name__: cls for cls in (TestRequest, TestResponse)},
    enum_types_by_name={},
)
