"""The messages of ``dht.proto`` (ping, store, find), declared by their field tables
on the port's own proto3 codec (``proto/wire.py``): the same names, field numbers
and types as the schema, so the wire bytes are protobuf's."""

from hivemind_tpu_torch.proto.wire import (
    BOOL,
    BYTES,
    DOUBLE,
    ENUM,
    MESSAGE,
    STRING,
    EnumType,
    Field,
    FileSchema,
    Message,
)

ResultType = EnumType("ResultType", {"NOT_FOUND": 0, "FOUND_REGULAR": 1, "FOUND_DICTIONARY": 2})
NOT_FOUND, FOUND_REGULAR, FOUND_DICTIONARY = ResultType.values()


class NodeInfo(Message):
    FIELDS = (
        Field("node_id", 1, BYTES),  # DHTID bytes (see dht/routing.py)
        Field("maddrs", 2, STRING, repeated=True),  # dialable addresses of the sender
        Field("auth_token", 3, BYTES),
    )


class PingRequest(Message):
    FIELDS = (
        Field("peer", 1, MESSAGE, message_type=NodeInfo),
        Field("validate", 2, BOOL),  # if true, respond with the sender's visible endpoint info
    )


class PingResponse(Message):
    FIELDS = (
        Field("peer", 1, MESSAGE, message_type=NodeInfo),
        Field("dht_time", 2, DOUBLE),
        Field("available", 3, BOOL),
    )


class StoreRequest(Message):
    FIELDS = (
        Field("keys", 1, BYTES, repeated=True),
        Field("subkeys", 2, BYTES, repeated=True),  # empty bytes: a plain (non-dictionary) store
        Field("values", 3, BYTES, repeated=True),
        Field("expiration_time", 4, DOUBLE, repeated=True),
        Field("in_cache", 5, BOOL, repeated=True),
        Field("peer", 6, MESSAGE, message_type=NodeInfo),
    )


class StoreResponse(Message):
    FIELDS = (
        Field("store_ok", 1, BOOL, repeated=True),
        Field("peer", 2, MESSAGE, message_type=NodeInfo),
    )


class FindRequest(Message):
    FIELDS = (
        Field("keys", 1, BYTES, repeated=True),
        Field("peer", 2, MESSAGE, message_type=NodeInfo),
    )


class PeerContact(Message):
    FIELDS = (
        Field("peer_id", 1, BYTES),  # transport PeerID bytes
        Field("maddrs", 2, STRING, repeated=True),
    )


class FindResult(Message):
    FIELDS = (
        Field("type", 1, ENUM, enum_type=ResultType),
        Field("value", 2, BYTES),  # a serialized value (regular) or dictionary
        Field("expiration_time", 3, DOUBLE),
        Field("nearest_node_ids", 4, BYTES, repeated=True),  # k nearest DHTIDs from the routing table
        Field("nearest_contacts", 5, MESSAGE, repeated=True, message_type=PeerContact),
    )


class FindResponse(Message):
    FIELDS = (
        Field("results", 1, MESSAGE, repeated=True, message_type=FindResult),
        Field("peer", 2, MESSAGE, message_type=NodeInfo),
    )


DESCRIPTOR = FileSchema(
    name="hivemind_tpu_torch/proto/dht.proto",
    package="hivemind_tpu_torch",
    message_types_by_name={cls.__name__: cls for cls in (NodeInfo, PingRequest, PingResponse, StoreRequest,
                                                         StoreResponse, FindRequest, PeerContact, FindResult,
                                                         FindResponse)},
    enum_types_by_name={"ResultType": ResultType},
)
