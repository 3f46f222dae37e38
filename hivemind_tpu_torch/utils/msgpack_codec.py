"""The port's own MessagePack codec: the subset of the ``msgpack`` package that the
port calls, written out so that the port loads on a machine without it.

``packb(obj, default=...)`` writes what ``msgpack.packb(obj, use_bin_type=True,
strict_types=True, default=...)`` writes, and ``unpackb(buf, ext_hook=...)``
reads what ``msgpack.unpackb(buf, ext_hook=..., raw=False,
strict_map_key=False)`` reads, byte for byte: those are the only options the
serializer uses. So:

- every int takes its smallest encoding (positive and negative fixint, then
  8/16/32/64-bit, unsigned for positives); an int outside int64 ∪ uint64 goes to
  ``default``, and raises ``OverflowError`` without one;
- a float is a float64 (``0xcb``);
- str is fixstr/str8/16/32 and bytes, bytearray and memoryview are bin8/16/32;
- an ``ExtType`` is fixext1/2/4/8/16 where its length is one of those, else
  ext8/16/32;
- types are strict: ``type(obj) is int`` and so on, so a tuple, an ``IntEnum``
  or a float subclass goes to ``default``; bool is tested before int.

Decoding copies nothing needless: a ``bin`` is one slice of the input, and a
memoryview input is read in place.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any, Callable, Optional

__all__ = ["ExtType", "ExtraData", "FormatError", "packb", "unpackb"]


class ExtType(namedtuple("ExtType", "code data")):
    """An extension value: a type code in [0, 127] and its payload bytes."""

    __slots__ = ()

    def __new__(cls, code: int, data: bytes):
        if not isinstance(code, int):
            raise TypeError("code must be int")
        if not isinstance(data, bytes):
            raise TypeError("data must be bytes")
        if not 0 <= code <= 127:
            raise ValueError("code must be 0~127")
        return super().__new__(cls, code, data)


class FormatError(ValueError):
    """The input holds a byte that starts no MessagePack value."""


class ExtraData(ValueError):
    """The input holds bytes past its one value."""

    def __init__(self, unpacked: Any, extra: bytes):
        super().__init__("unpack(b) received extra data.")
        self.unpacked, self.extra = unpacked, extra


_RECURSE_LIMIT = 511
_U16, _U32, _U64 = struct.Struct(">H"), struct.Struct(">I"), struct.Struct(">Q")
_I8, _I16, _I32, _I64 = struct.Struct(">b"), struct.Struct(">h"), struct.Struct(">i"), struct.Struct(">q")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ------------------------------------------------------------------ encoding


def _pack_int(value: int, out: bytearray) -> None:
    if value < -(1 << 5):
        if value < -(1 << 15):
            if value < -(1 << 31):
                out += b"\xd3" + _I64.pack(value)
            else:
                out += b"\xd2" + _I32.pack(value)
        elif value < -(1 << 7):
            out += b"\xd1" + _I16.pack(value)
        else:
            out += b"\xd0" + _I8.pack(value)
    elif value < (1 << 7):
        out.append(value & 0xFF)  # positive fixint, or negative fixint 0xe0..0xff
    elif value < (1 << 16):
        out += bytes((0xCC, value)) if value < (1 << 8) else b"\xcd" + _U16.pack(value)
    elif value < (1 << 32):
        out += b"\xce" + _U32.pack(value)
    else:
        out += b"\xcf" + _U64.pack(value)


def _pack_length(length: int, out: bytearray, fix_base: Optional[int], fix_limit: int, codes, what: str) -> None:
    """The header of a str/bin/array/map: fix form below ``fix_limit``, then the
    8/16/32-bit forms ``codes`` (an entry None has no 8-bit form)."""
    code8, code16, code32 = codes
    if fix_base is not None and length < fix_limit:
        out.append(fix_base | length)
    elif code8 is not None and length < (1 << 8):
        out += bytes((code8, length))
    elif length < (1 << 16):
        out += bytes((code16,)) + _U16.pack(length)
    elif length < (1 << 32):
        out += bytes((code32,)) + _U32.pack(length)
    else:
        raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: bytearray, default: Optional[Callable[[Any], Any]], depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    default_used = False
    while True:
        kind = type(obj)
        if obj is None:
            out.append(0xC0)
        elif obj is True:
            out.append(0xC3)
        elif obj is False:
            out.append(0xC2)
        elif kind is int:
            if not -(1 << 63) <= obj < (1 << 64):
                if default is not None and not default_used:
                    obj, default_used = default(obj), True
                    continue
                raise OverflowError("Integer value out of range")
            _pack_int(obj, out)
        elif kind is float:
            out += b"\xcb" + _F64.pack(obj)
        elif kind is bytes or kind is bytearray or kind is memoryview:
            data = obj.cast("B") if kind is memoryview else obj
            _pack_length(len(data), out, None, 0, (0xC4, 0xC5, 0xC6), "bytes object")
            out += data
        elif kind is str:
            data = obj.encode("utf-8")
            _pack_length(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB), "unicode string")
            out += data
        elif kind is dict:
            _pack_length(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF), "dict")
            for key, value in obj.items():
                _pack(key, out, default, depth - 1)
                _pack(value, out, default, depth - 1)
        elif kind is ExtType:
            code, data = obj
            length = len(data)
            if length in _FIXEXT:
                out.append(_FIXEXT[length])
            else:
                _pack_length(length, out, None, 0, (0xC7, 0xC8, 0xC9), "EXT data")
            out += _I8.pack(code) + data
        elif kind is list:
            _pack_length(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD), "list")
            for item in obj:
                _pack(item, out, default, depth - 1)
        elif default is not None and not default_used:
            obj, default_used = default(obj), True
            continue
        else:
            raise TypeError(f"can not serialize {kind.__name__!r} object")
        return


def packb(obj: Any, *, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """``obj`` as MessagePack bytes (``use_bin_type=True, strict_types=True``)."""
    out = bytearray()
    _pack(obj, out, default, _RECURSE_LIMIT)
    return bytes(out)


# ------------------------------------------------------------------ decoding


class _Reader:
    __slots__ = ("buf", "pos", "ext_hook")

    def __init__(self, buf: memoryview, ext_hook: Optional[Callable[[int, bytes], Any]]):
        self.buf, self.pos, self.ext_hook = buf, 0, ext_hook

    def take(self, count: int) -> memoryview:
        start, end = self.pos, self.pos + count
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        self.pos = end
        return self.buf[start:end]

    def unpack(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))[0]

    def length(self, code: int, base8: int) -> int:
        """The length that follows a str/bin/ext header of the 8/16/32-bit family
        starting at ``base8``."""
        width = code - base8
        return self.take(1)[0] if width == 0 else self.unpack(_U16 if width == 1 else _U32)

    def ext(self, length: int) -> Any:
        code = self.unpack(_I8)
        data = bytes(self.take(length))
        if self.ext_hook is not None:
            return self.ext_hook(code, data)
        return ExtType(code, data)

    def value(self, depth: int) -> Any:
        if depth < 0:
            raise ValueError("recursion limit exceeded.")
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if 0x90 <= code <= 0x9F:
            return [self.value(depth - 1) for _ in range(code & 0x0F)]
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F, depth)
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        if 0xC4 <= code <= 0xC6:
            return bytes(self.take(self.length(code, 0xC4)))
        if 0xC7 <= code <= 0xC9:
            return self.ext(self.length(code, 0xC7))
        if code == 0xCA:
            return self.unpack(_F32)
        if code == 0xCB:
            return self.unpack(_F64)
        if code == 0xCC:
            return self.take(1)[0]
        if 0xCD <= code <= 0xD3:
            return self.unpack((_U16, _U32, _U64, _I8, _I16, _I32, _I64)[code - 0xCD])
        if 0xD4 <= code <= 0xD8:
            return self.ext(1 << (code - 0xD4))
        if 0xD9 <= code <= 0xDB:
            return str(self.take(self.length(code, 0xD9)), "utf-8")
        if code in (0xDC, 0xDD):
            return [self.value(depth - 1) for _ in range(self.unpack(_U16 if code == 0xDC else _U32))]
        if code in (0xDE, 0xDF):
            return self.map(self.unpack(_U16 if code == 0xDE else _U32), depth)
        raise FormatError()  # 0xc1, never used

    def map(self, count: int, depth: int) -> dict:
        result = {}
        for _ in range(count):
            key = self.value(depth - 1)
            result[key] = self.value(depth - 1)
        return result


def unpackb(buf, *, ext_hook: Optional[Callable[[int, bytes], Any]] = None) -> Any:
    """The one value that ``buf`` (bytes-like) encodes (``raw=False,
    strict_map_key=False``): str as str, bin as bytes, ext through ``ext_hook``
    (or as ``ExtType``). Raises ``ValueError`` on incomplete input,
    ``FormatError`` on a byte that starts no value and ``ExtraData`` on bytes
    past the value."""
    view = memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    reader = _Reader(view, ext_hook)
    result = reader.value(_RECURSE_LIMIT)
    if reader.pos != len(view):
        raise ExtraData(result, bytes(view[reader.pos:]))
    return result

