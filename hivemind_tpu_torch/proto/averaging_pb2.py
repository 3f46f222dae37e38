"""The messages of ``averaging.proto`` (matchmaking, the butterfly all-reduce and the
state download), declared by their field tables on the port's own proto3 codec
(``proto/wire.py``): the same names, field numbers and types as the schema, so the
wire bytes are protobuf's."""

from hivemind_tpu_torch.proto.runtime_pb2 import Tensor
from hivemind_tpu_torch.proto.wire import (
    BOOL,
    BYTES,
    DOUBLE,
    ENUM,
    MESSAGE,
    STRING,
    UINT32,
    UINT64,
    EnumType,
    Field,
    FileSchema,
    Message,
)

MessageCode = EnumType(
    "MessageCode",
    {
        "NO_CODE": 0,
        # matchmaking
        "REQUEST_JOIN": 1,
        "ACCEPTED": 2,
        "BEGIN_ALLREDUCE": 3,
        "GROUP_DISBANDED": 4,
        "REJECT_WRONG_GROUP_KEY": 5,
        "REJECT_DUPLICATE_PEER_ID": 6,
        "REJECT_GROUP_IS_FULL": 7,
        "REJECT_NOT_LOOKING_FOR_GROUP": 8,
        "REJECT_REQUEST_TO_CLIENT": 9,
        "REJECT_WRONG_TIME": 10,
        "REJECT_TOO_LATE": 11,
        "REJECT_CANCELLED": 12,
        "REJECT_EXPIRED": 13,
        # all-reduce
        "PART_DATA": 14,
        "PART_FAILED": 15,
        "CANCELLED": 16,
        "INTERNAL_ERROR": 17,
        "PROTOCOL_VIOLATION": 18,
    },
)
(NO_CODE, REQUEST_JOIN, ACCEPTED, BEGIN_ALLREDUCE, GROUP_DISBANDED, REJECT_WRONG_GROUP_KEY,
 REJECT_DUPLICATE_PEER_ID, REJECT_GROUP_IS_FULL, REJECT_NOT_LOOKING_FOR_GROUP, REJECT_REQUEST_TO_CLIENT,
 REJECT_WRONG_TIME, REJECT_TOO_LATE, REJECT_CANCELLED, REJECT_EXPIRED, PART_DATA, PART_FAILED, CANCELLED,
 INTERNAL_ERROR, PROTOCOL_VIOLATION) = MessageCode.values()


class JoinRequest(Message):
    FIELDS = (
        Field("group_key", 1, BYTES),  # current group key ({prefix}.0b{bits})
        Field("expiration", 2, DOUBLE),  # requester's declared expiration time
        Field("gather", 3, BYTES),  # opaque metadata gathered across the group
        Field("client_mode", 4, BOOL),  # sender cannot accept inbound reduction work
        Field("schema_hash", 5, STRING),  # groupmates must average identical schemas
    )


class MessageFromLeader(Message):
    FIELDS = (
        Field("code", 1, ENUM, enum_type=MessageCode),
        Field("group_id", 2, BYTES),  # random unique id of the assembled group
        Field("suggested_leader", 3, BYTES),  # peer id to try instead (on disband)
        Field("ordered_peer_ids", 4, BYTES, repeated=True),
        Field("gathered", 5, BYTES, repeated=True),  # gather blobs in ordered_peer_ids order
    )


class AveragingData(Message):
    FIELDS = (
        Field("code", 1, ENUM, enum_type=MessageCode),
        Field("group_id", 2, BYTES),
        Field("part_index", 3, UINT32),
        Field("tensor_part", 4, MESSAGE, message_type=Tensor),
        Field("weight", 5, DOUBLE),
        # the quantized leg: tensor_part carries the reduced average of this part
        # (quantized once, with the reducer's error feedback), not a per-sender delta
        Field("absolute_part", 6, BOOL),
    )


class DownloadRequest(Message):
    FIELDS = (
        Field("have_tensors", 1, UINT32, repeated=True),  # tensor indices the receiver holds verified
        Field("manifest_only", 2, BOOL),  # striping probe: manifest, then end of stream
    )


class TensorManifest(Message):
    FIELDS = (
        Field("num_bytes", 1, UINT64),  # length of the serialized tensor's payload
        Field("digest", 2, BYTES),  # blake2b-16 over the serialized payload
    )


class StateManifest(Message):
    FIELDS = (
        Field("schema_hash", 1, STRING),  # donor's averager schema fingerprint
        Field("epoch", 2, UINT64),  # donor's local epoch at snapshot time
        Field("state_unavailable", 3, BOOL),  # sharing disabled, distinct from truncation
        Field("tensors", 4, MESSAGE, repeated=True, message_type=TensorManifest),
        Field("metadata", 5, BYTES),  # msgpack user metadata (epoch etc.)
    )


class DownloadData(Message):
    FIELDS = (
        Field("metadata", 1, BYTES),  # pre-manifest metadata, kept for wire compatibility
        Field("tensor_part", 2, MESSAGE, message_type=Tensor),
        Field("manifest", 3, MESSAGE, message_type=StateManifest),  # first message of every download stream
        Field("tensor_index", 4, UINT32),  # which manifest entry this tensor_part belongs to
    )


DESCRIPTOR = FileSchema(
    name="hivemind_tpu_torch/proto/averaging.proto",
    package="hivemind_tpu_torch",
    message_types_by_name={cls.__name__: cls for cls in (JoinRequest, MessageFromLeader, AveragingData,
                                                         DownloadRequest, DownloadData, TensorManifest,
                                                         StateManifest)},
    enum_types_by_name={"MessageCode": MessageCode},
)
