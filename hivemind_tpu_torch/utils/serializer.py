"""MessagePack serialization with an extension-type registry, the wire format of
DHT values and control metadata (the port's copy of
hivemind_tpu/utils/serializer.py, with the same extension codes: 0x40 for tuples,
0x50 and up for registered classes), on the port's own MessagePack codec
(``utils/msgpack_codec.py``), so it loads where the ``msgpack`` package is
missing."""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Type, TypeVar

from hivemind_tpu_torch.utils import msgpack_codec
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

T = TypeVar("T")

_TUPLE_EXT_CODE = 0x40


class SerializerBase(ABC):
    @staticmethod
    @abstractmethod
    def dumps(obj: Any) -> bytes: ...

    @staticmethod
    @abstractmethod
    def loads(buf: bytes) -> Any: ...


class MSGPackSerializer(SerializerBase):
    """msgpack with two extension families: tuples (code 0x40) and user classes
    registered via ``ext_serializable`` (codes ≥ 0x50). Registered classes must
    provide ``packb() -> bytes`` and ``unpackb(cls, data) -> instance``."""

    _ext_types: Dict[int, Type] = {}
    _lock = threading.Lock()

    @classmethod
    def ext_serializable(cls, type_code: int) -> Callable[[Type[T]], Type[T]]:
        if not (isinstance(type_code, int) and 0 <= type_code <= 127):
            raise ValueError(f"msgpack ext codes are ints in [0, 127], got {type_code!r}")

        def wrap(wrapped_type: Type[T]) -> Type[T]:
            if not (callable(getattr(wrapped_type, "packb", None)) and callable(getattr(wrapped_type, "unpackb", None))):
                raise TypeError(f"{wrapped_type} must define packb() and classmethod unpackb(data)")
            with cls._lock:
                existing = cls._ext_types.get(type_code)
                if existing is not None and existing.__name__ != wrapped_type.__name__:
                    raise ValueError(f"msgpack ext code {type_code} already taken by {existing}")
                cls._ext_types[type_code] = wrapped_type
            return wrapped_type

        return wrap

    @classmethod
    def _encode_ext_types(cls, obj):
        # the exact type first, then the most derived isinstance match, so a
        # subclass registered under its own code is not shadowed by its base
        for code, ext_type in cls._ext_types.items():
            if type(obj) is ext_type:
                return msgpack_codec.ExtType(code, obj.packb())
        best = None
        for code, ext_type in cls._ext_types.items():
            if isinstance(obj, ext_type) and (best is None or issubclass(ext_type, best[1])):
                best = (code, ext_type)
        if best is not None:
            return msgpack_codec.ExtType(best[0], obj.packb())
        if isinstance(obj, tuple):
            return msgpack_codec.ExtType(_TUPLE_EXT_CODE, msgpack_codec.packb(list(obj), default=cls._encode_ext_types))
        raise TypeError(f"cannot serialize {obj!r} ({type(obj)})")

    @classmethod
    def _decode_ext_types(cls, code: int, data: bytes):
        if code == _TUPLE_EXT_CODE:
            return tuple(msgpack_codec.unpackb(data, ext_hook=cls._decode_ext_types))
        if code in cls._ext_types:
            return cls._ext_types[code].unpackb(data)
        logger.warning(f"unknown msgpack ext code {code}, returning raw bytes")
        return data

    @classmethod
    def dumps(cls, obj: Any) -> bytes:
        return msgpack_codec.packb(obj, default=cls._encode_ext_types)

    @classmethod
    def loads(cls, buf: bytes) -> Any:
        return msgpack_codec.unpackb(buf, ext_hook=cls._decode_ext_types)


# the tensor descriptors' codes, as the JAX package registers them
from hivemind_tpu_torch.utils.tensor_descr import BatchTensorDescriptor, TensorDescriptor  # noqa: E402

MSGPackSerializer.ext_serializable(0x51)(TensorDescriptor)
MSGPackSerializer.ext_serializable(0x52)(BatchTensorDescriptor)
