"""A table-driven proto3 codec: the subset of protobuf's Python API that the port
calls, so that the port's messages load where ``google.protobuf`` is missing.

A message class lists its fields in ``FIELDS`` (name, number, type; repeated or
not; the message or enum type), the table that ``protoc`` would compile from the
``.proto`` file. The types are the ones ``runtime.proto``, ``dht.proto`` and
``averaging.proto`` use: bytes, string, uint32, uint64, bool, enum, double and
messages, singular or repeated.
Instances take keyword constructors and attribute access; a repeated field is a
list with ``add()`` for message elements. The bytes are proto3's:

- fields are written in ascending field number;
- a scalar field that holds its default (0, 0.0 but not -0.0, "", b"", False,
  an empty list) is not written;
- repeated scalars are packed (a double as 8 little-endian bytes);
- a singular message field has presence, as in protobuf: an absent one reads as
  a default instance and is not written, ``HasField`` tells the two apart, a
  set one is written even when it is empty, and setting a field of the default
  instance (``msg.peer.node_id = ...``) makes it present. It is set through the
  constructor, ``CopyFrom`` or its own fields, never by assignment.

The parser also takes the unpacked form of a repeated scalar, skips unknown
fields of every wire type, and keeps the last value of a scalar field that
occurs more than once. A ``bytes`` field keeps
what it is given (a memoryview is not copied), and a parsed ``bytes`` field of
``ZERO_COPY_BYTES`` or more is a memoryview slice of the input.

``encode_varint`` and ``encode_tag`` are the port's one varint, also used by the
scatter-gather frames of ``compression/serialization.py``.
"""

from __future__ import annotations

import operator
import struct
from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple, Type

VARINT, FIXED64, LENGTH_DELIMITED, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5

# field types, with protobuf's names
BOOL, STRING, MESSAGE, BYTES, UINT32, UINT64, ENUM, DOUBLE = (
    "bool", "string", "message", "bytes", "uint32", "uint64", "enum", "double")
_WIRE_TYPES = {BOOL: VARINT, STRING: LENGTH_DELIMITED, MESSAGE: LENGTH_DELIMITED, BYTES: LENGTH_DELIMITED,
               UINT32: VARINT, UINT64: VARINT, ENUM: VARINT, DOUBLE: FIXED64}
_DEFAULTS = {BOOL: False, STRING: "", BYTES: b"", UINT32: 0, UINT64: 0, ENUM: 0, DOUBLE: 0.0}
_PACKABLE = frozenset({BOOL, UINT32, UINT64, ENUM, DOUBLE})
_DOUBLE = struct.Struct("<d")
_INT_RANGES = {UINT32: (0, 1 << 32), UINT64: (0, 1 << 64), ENUM: (-(1 << 31), 1 << 31)}
_MASK64 = (1 << 64) - 1

# parsed bytes fields at least this long stay views of the input (a tensor buffer);
# shorter ones are copied into bytes
ZERO_COPY_BYTES = 4096


class DecodeError(ValueError):
    """The input is not a well-formed encoding of the message."""


# ------------------------------------------------------------------ varints and tags


def encode_varint(value: int) -> bytes:
    """An unsigned LEB128 varint (negative values as their 64-bit two's complement)."""
    value &= _MASK64
    if value < 0x80:
        return bytes((value,))
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def encode_tag(number: int, wire_type: int) -> bytes:
    return encode_varint((number << 3) | wire_type)


def varint_size(value: int) -> int:
    value &= _MASK64
    size = 1
    while value >= 0x80:
        value >>= 7
        size += 1
    return size


def decode_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    """(value, position after it) of the varint at ``pos``."""
    result = shift = 0
    end = len(buf)
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


# ------------------------------------------------------------------ schema


class EnumType:
    """An enum's names and numbers (protobuf's ``EnumTypeWrapper`` subset):
    attribute access by name, ``Name``, ``Value``, ``keys``, ``values``, ``items``."""

    def __init__(self, name: str, values: Mapping[str, int]):
        self.name = name
        self._by_name = dict(values)
        self._by_number = {number: key for key, number in reversed(list(self._by_name.items()))}

    def __getattr__(self, key: str) -> int:
        try:
            return self.__dict__["_by_name"][key]
        except KeyError:
            raise AttributeError(key) from None

    def Name(self, number: int) -> str:
        try:
            return self._by_number[number]
        except KeyError:
            raise ValueError(f"enum {self.name} has no name defined for value {number!r}") from None

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"enum {self.name} has no value defined for name {name!r}") from None

    def keys(self) -> List[str]:
        return list(self._by_name)

    def values(self) -> List[int]:
        return list(self._by_name.values())

    def items(self) -> List[Tuple[str, int]]:
        return list(self._by_name.items())


class Field(NamedTuple):
    """One row of a message's field table."""

    name: str
    number: int
    type: str
    repeated: bool = False
    message_type: Optional[Type["Message"]] = None
    enum_type: Optional[EnumType] = None

    @property
    def wire_type(self) -> int:
        return _WIRE_TYPES[self.type]


def _coerce(field: Field, value: Any) -> Any:
    """``value`` as the field's Python type, or TypeError/ValueError as protobuf raises."""
    kind = field.type
    if kind in _INT_RANGES:
        if isinstance(value, bool) and kind != ENUM:
            value = int(value)
        value = operator.index(value)
        low, high = _INT_RANGES[kind]
        if not low <= value < high:
            raise ValueError(f"value out of range for {kind} field {field.name!r}: {value}")
        return value
    if kind == BOOL:
        return bool(operator.index(value))
    if kind == DOUBLE:
        if not isinstance(value, (int, float)):
            raise TypeError(f"field {field.name!r} takes a number, not {type(value).__name__}")
        return float(value)
    if kind == STRING:
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"field {field.name!r} takes str, not {type(value).__name__}")
        return value
    if kind == BYTES:
        if not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"field {field.name!r} takes bytes, not {type(value).__name__}")
        return value
    if not isinstance(value, field.message_type):
        raise TypeError(f"field {field.name!r} takes {field.message_type.__name__}, not {type(value).__name__}")
    return value


class RepeatedField(list):
    """A repeated field: a list whose elements are checked as they arrive, with
    ``add(**fields)`` for message elements."""

    __slots__ = ("_field", "_owner")

    def __init__(self, field: Field, values: Iterable[Any] = (), owner: Optional["Message"] = None):
        super().__init__(_coerce(field, value) for value in values)
        self._field = field
        self._owner = owner  # the message holding this list, told when it grows

    def append(self, value: Any) -> None:
        super().append(_coerce(self._field, value))
        self._touched()

    def extend(self, values: Iterable[Any]) -> None:
        super().extend(_coerce(self._field, value) for value in values)
        self._touched()

    def add(self, **fields: Any) -> "Message":
        if self._field.message_type is None:
            raise AttributeError(f"add() is for message fields; {self._field.name!r} holds {self._field.type}")
        message = self._field.message_type(**fields)
        super().append(message)
        self._touched()
        return message

    def _touched(self) -> None:
        if self._owner is not None:
            self._owner._touched()


class _MessageMeta(type):
    """Gives each message class slots for its fields, its table in field-number
    order, and lookups by name and number."""

    def __new__(mcs, name, bases, namespace):
        fields = tuple(sorted(namespace.get("FIELDS", ()), key=lambda field: field.number))
        for field in fields:
            if field.type not in _WIRE_TYPES:
                raise TypeError(f"{name}.{field.name}: a {field.type} field is not in the codec's subset")
            if field.type == MESSAGE and field.message_type is None:
                raise TypeError(f"{name}.{field.name}: a message field names its message type")
        singular = tuple(field for field in fields if field.type == MESSAGE and not field.repeated)
        slots = [field.name for field in fields if field not in singular]
        # a singular message lives in a slot of its own behind a property, which makes
        # the default instance on first read
        slots += [f"_m_{field.name}" for field in singular] + ["_present", "_owner"]
        for field in singular:
            namespace[field.name] = _singular_message_property(field)
        namespace.update(FIELDS=fields, __slots__=tuple(slots),
                         _FIELDS_BY_NAME={field.name: field for field in fields},
                         _FIELDS_BY_NUMBER={field.number: field for field in fields})
        return super().__new__(mcs, name, bases, namespace)


def _singular_message_property(field: Field) -> property:
    slot = f"_m_{field.name}"

    def get(self: "Message") -> "Message":
        value = object.__getattribute__(self, slot)
        if value is None:  # absent: a default instance that makes the field present once it is set
            value = field.message_type()
            object.__setattr__(value, "_owner", (self, field.name))
            object.__setattr__(self, slot, value)
        return value

    def refuse(self: "Message", value: Any) -> None:
        raise AttributeError(f'Assignment not allowed to message field "{field.name}" in protocol message object.')

    return property(get, refuse)


def _is_default(field: Field, value: Any) -> bool:
    if field.type == DOUBLE and not field.repeated:
        return _DOUBLE.pack(value) == b"\0" * 8  # 0.0 is the default, -0.0 is written
    return not value  # 0, False, "", b"" or an empty repeated field


def _scalar_bytes(field: Field, value: Any) -> bytes:
    if field.type == STRING:
        return value.encode("utf-8")
    if field.type == DOUBLE:
        return _DOUBLE.pack(value)
    return encode_varint(int(value))


class Message(metaclass=_MessageMeta):
    """A proto3 message declared by its field table (see the module docstring)."""

    FIELDS: Tuple[Field, ...] = ()
    _FIELDS_BY_NAME: Dict[str, Field] = {}
    _FIELDS_BY_NUMBER: Dict[int, Field] = {}

    def __init__(self, **fields: Any):
        object.__setattr__(self, "_present", set())
        if not hasattr(self, "_owner"):
            object.__setattr__(self, "_owner", None)
        for field in self.FIELDS:
            value = fields.pop(field.name, None)
            if field.repeated:
                object.__setattr__(self, field.name,
                                   RepeatedField(field, value if value is not None else (), owner=self))
            elif field.type == MESSAGE:
                object.__setattr__(self, f"_m_{field.name}", None)
                if value is not None:
                    self._set_message(field, _coerce(field, value))
            else:
                object.__setattr__(self, field.name, _DEFAULTS[field.type] if value is None else _coerce(field, value))
        if fields:
            raise ValueError(f"{type(self).__name__} has no field(s) {sorted(fields)}")

    def _set_message(self, field: Field, value: "Message") -> None:
        """Make a singular message field present, holding a copy of ``value``."""
        getattr(self, field.name).CopyFrom(value)
        self._present.add(field.name)

    def __setattr__(self, name: str, value: Any) -> None:
        field = self._FIELDS_BY_NAME.get(name)
        if field is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if field.type == MESSAGE and not field.repeated:
            getattr(type(self), name).fset(self, value)  # refuses, as protobuf does
        object.__setattr__(self, name, RepeatedField(field, value, owner=self) if field.repeated
                           else _coerce(field, value))
        self._touched()

    def _touched(self) -> None:
        """A field of this message was set: a default instance read from its parent's
        absent field becomes present there (and so on up)."""
        owner = self._owner
        if owner is not None:
            parent, name = owner
            object.__setattr__(self, "_owner", None)
            parent._present.add(name)
            parent._touched()

    def HasField(self, name: str) -> bool:
        field = self._FIELDS_BY_NAME.get(name)
        if field is None:
            raise ValueError(f'Protocol message {type(self).__name__} has no field {name}.')
        if field.type != MESSAGE or field.repeated:
            raise ValueError(f"Field {type(self).__name__}.{name} does not have presence.")
        return name in self._present

    def _value_or_absent(self, field: Field) -> Any:
        if field.type == MESSAGE and not field.repeated:
            return getattr(self, field.name) if field.name in self._present else None
        return getattr(self, field.name)

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(self._value_or_absent(f) == other._value_or_absent(f) for f in self.FIELDS)

    def __repr__(self) -> str:
        shown = []
        for field in self.FIELDS:
            value = self._value_or_absent(field)
            if field.type == MESSAGE and not field.repeated:
                if value is not None:
                    shown.append(f"{field.name}={value!r}")
            elif not _is_default(field, value):
                if field.type == BYTES and not field.repeated and len(value) > 32:
                    value = f"<{len(value)} bytes>"
                shown.append(f"{field.name}={value!r}")
        return f"{type(self).__name__}({', '.join(shown)})"

    # ---------------------------------------------------------------- encoding

    def _encode_into(self, out: List[Any]) -> None:
        for field in self.FIELDS:
            if field.type == MESSAGE and not field.repeated:
                if field.name not in self._present:
                    continue
                value = getattr(self, field.name)
            else:
                value = getattr(self, field.name)
                if _is_default(field, value):
                    continue
            if field.repeated and field.type in _PACKABLE:
                body = b"".join(_scalar_bytes(field, item) for item in value)
                out += (encode_tag(field.number, LENGTH_DELIMITED), encode_varint(len(body)), body)
                continue
            for item in (value if field.repeated else (value,)):
                out.append(encode_tag(field.number, field.wire_type))
                if field.type == MESSAGE:
                    inner: List[Any] = []
                    item._encode_into(inner)
                    out.append(encode_varint(sum(len(part) for part in inner)))
                    out += inner
                elif field.type == BYTES:
                    out += (encode_varint(len(item)), item)
                elif field.type == STRING:
                    data = item.encode("utf-8")
                    out += (encode_varint(len(data)), data)
                else:
                    out.append(_scalar_bytes(field, item))

    def SerializeToString(self) -> bytes:
        parts: List[Any] = []
        self._encode_into(parts)
        return b"".join(parts)

    def ByteSize(self) -> int:
        size = 0
        for field in self.FIELDS:
            if field.type == MESSAGE and not field.repeated:
                if field.name not in self._present:
                    continue
                value = getattr(self, field.name)
            else:
                value = getattr(self, field.name)
                if _is_default(field, value):
                    continue
            tag_size = varint_size(field.number << 3)
            if field.repeated and field.type in _PACKABLE:
                body = sum(len(_scalar_bytes(field, item)) for item in value)
                size += tag_size + varint_size(body) + body
                continue
            for item in (value if field.repeated else (value,)):
                if field.type == MESSAGE:
                    length = item.ByteSize()
                elif field.type == BYTES:
                    length = len(item)
                elif field.type == STRING:
                    length = len(item.encode("utf-8"))
                else:
                    size += tag_size + len(_scalar_bytes(field, item))
                    continue
                size += tag_size + varint_size(length) + length
        return size

    # ---------------------------------------------------------------- decoding

    def _merge(self, buf: memoryview) -> None:
        by_number = self._FIELDS_BY_NUMBER
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = decode_varint(buf, pos)
            number, wire_type = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            field = by_number.get(number)
            if field is None or (wire_type != field.wire_type
                                 and not (field.repeated and field.type in _PACKABLE and wire_type == LENGTH_DELIMITED)):
                pos = _skip(buf, pos, wire_type, number)
                continue
            if wire_type == LENGTH_DELIMITED:
                length, pos = decode_varint(buf, pos)
                if pos + length > end:
                    raise DecodeError(f"field {field.name!r} runs past the end of the input")
                chunk, pos = buf[pos:pos + length], pos + length
                if field.type in _PACKABLE:  # a packed repeated scalar
                    values = getattr(self, field.name)
                    inner = 0
                    while inner < length:
                        value, inner = _read_scalar(field, chunk, inner)
                        list.append(values, value)
                    if inner != length:
                        raise DecodeError(f"packed field {field.name!r} overruns its length")
                    continue
                if field.type == MESSAGE:
                    if field.repeated:
                        message = field.message_type()
                        message._merge(chunk)
                        list.append(getattr(self, field.name), message)
                    else:  # a singular message merges every occurrence, as protobuf does
                        getattr(self, field.name)._merge(chunk)
                        self._present.add(field.name)
                    continue
                if field.type == STRING:
                    try:
                        value = str(chunk, "utf-8")
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"field {field.name!r} is not valid UTF-8") from e
                else:
                    value = chunk if length >= ZERO_COPY_BYTES else bytes(chunk)
            else:
                value, pos = _read_scalar(field, buf, pos)
            if field.repeated:
                list.append(getattr(self, field.name), value)
            else:
                object.__setattr__(self, field.name, value)

    def ParseFromString(self, data) -> int:
        """Replace this message's fields with the ones ``data`` (bytes-like) encodes."""
        view = memoryview(data)
        if view.format != "B" or view.ndim != 1:
            view = view.cast("B")
        type(self).__init__(self)
        self._merge(view)
        return len(view)

    @classmethod
    def FromString(cls, data) -> "Message":
        message = cls()
        message.ParseFromString(data)
        return message

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom takes {type(self).__name__}, not {type(other).__name__}")
        if other is self:
            return
        for field in self.FIELDS:
            if field.type == MESSAGE and not field.repeated:
                copy = field.message_type()
                if field.name in other._present:
                    copy.CopyFrom(getattr(other, field.name))
                    self._present.add(field.name)
                else:
                    self._present.discard(field.name)
                    copy = None
                object.__setattr__(self, f"_m_{field.name}", copy)
                continue
            value = getattr(other, field.name)
            if field.type == MESSAGE:  # repeated: copied element by element
                value = [type(item)() for item in value]
                for copy, item in zip(value, getattr(other, field.name)):
                    copy.CopyFrom(item)
            object.__setattr__(self, field.name, RepeatedField(field, value, owner=self) if field.repeated else value)
        self._touched()

def _read_scalar(field: Field, buf: memoryview, pos: int) -> Tuple[Any, int]:
    if field.type == DOUBLE:
        if pos + 8 > len(buf):
            raise DecodeError(f"truncated double in field {field.name!r}")
        return _DOUBLE.unpack_from(buf, pos)[0], pos + 8
    raw, pos = decode_varint(buf, pos)
    if field.type == BOOL:
        return raw != 0, pos
    if field.type == UINT64:
        return raw, pos  # decode_varint already kept the low 64 bits
    raw &= 0xFFFFFFFF
    if field.type == UINT32:
        return raw, pos
    return raw - (1 << 32) if raw >> 31 else raw, pos  # an enum: the low 32 bits, signed


def _skip(buf: memoryview, pos: int, wire_type: int, number: int) -> int:
    """The position after an unknown field's value."""
    if wire_type == VARINT:
        return decode_varint(buf, pos)[1]
    if wire_type == FIXED64:
        end = pos + 8
    elif wire_type == FIXED32:
        end = pos + 4
    elif wire_type == LENGTH_DELIMITED:
        length, pos = decode_varint(buf, pos)
        end = pos + length
    elif wire_type == START_GROUP:
        while True:
            key, pos = decode_varint(buf, pos)
            if key & 7 == END_GROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, key & 7, key >> 3)
    else:
        raise DecodeError(f"unexpected wire type {wire_type}")
    if end > len(buf):
        raise DecodeError("unknown field runs past the end of the input")
    return end


class FileSchema(NamedTuple):
    """What a ``.proto`` file declares: its name, package, messages and enums
    (the fields of protobuf's ``FileDescriptor`` that the port reads)."""

    name: str
    package: str
    message_types_by_name: Mapping[str, Type[Message]]
    enum_types_by_name: Mapping[str, EnumType]
