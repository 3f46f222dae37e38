"""The messages of ``runtime.proto`` (tensors and expert RPCs), declared by their
field tables on the port's own proto3 codec (``proto/wire.py``): the same names,
field numbers and types as the schema, so the wire bytes are protobuf's."""

from hivemind_tpu_torch.proto.wire import (
    BOOL,
    BYTES,
    ENUM,
    MESSAGE,
    STRING,
    UINT32,
    EnumType,
    Field,
    FileSchema,
    Message,
)

CompressionType = EnumType(
    "CompressionType",
    {"NONE": 0, "FLOAT16": 1, "MEANSTD_16BIT": 2, "UNIFORM_8BIT": 3, "QUANTILE_8BIT": 4, "BLOCKWISE_8BIT": 5},
)
NONE, FLOAT16, MEANSTD_16BIT, UNIFORM_8BIT, QUANTILE_8BIT, BLOCKWISE_8BIT = CompressionType.values()


class Tensor(Message):
    FIELDS = (
        Field("buffer", 1, BYTES),
        Field("size", 2, UINT32, repeated=True),
        Field("dtype", 3, STRING),
        Field("requires_grad", 4, BOOL),
        Field("compression", 5, ENUM, enum_type=CompressionType),
        Field("chunks", 6, UINT32),  # when a tensor is split for streaming: total chunk count
    )


class ExpertUID(Message):
    FIELDS = (Field("uid", 1, STRING),)


class ExpertRequest(Message):
    FIELDS = (
        Field("uid", 1, STRING),
        Field("tensors", 2, MESSAGE, repeated=True, message_type=Tensor),
        Field("metadata", 3, BYTES),  # msgpack: task metadata (schema, batch info)
    )


class ExpertResponse(Message):
    FIELDS = (
        Field("tensors", 1, MESSAGE, repeated=True, message_type=Tensor),
        Field("metadata", 2, BYTES),
    )


class ExpertInfoResponse(Message):
    FIELDS = (Field("serialized_info", 1, BYTES),)  # msgpack: forward/backward schemas, max_batch_size


DESCRIPTOR = FileSchema(
    name="hivemind_tpu_torch/proto/runtime.proto",
    package="hivemind_tpu_torch",
    message_types_by_name={cls.__name__: cls for cls in (Tensor, ExpertUID, ExpertRequest, ExpertResponse,
                                                         ExpertInfoResponse)},
    enum_types_by_name={"CompressionType": CompressionType},
)
