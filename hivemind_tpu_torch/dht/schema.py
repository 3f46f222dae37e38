"""Schema-validated DHT records (the port of hivemind_tpu/dht/schema.py, written
without pydantic; upstream: hivemind/dht/schema.py).

A schema is a plain field table: each DHT key name maps to a *type*, a callable that
takes a decoded msgpack value and returns it coerced, or raises ``ValueError``. The
types here accept and reject exactly what pydantic v2 does in lax mode, which is how
the JAX package validates the same records:

- ``int``: ints, bools, floats with no fraction, and strings (or bytes) of ASCII
  digits with an optional sign, underscores and a ``.0…`` tail;
- ``float``: ints, bools, floats, and strings that Python's ``float`` parses;
- ``bool``: bools, the ints and floats 0 and 1, and the strings ``0 off f false n no``
  / ``1 on t true y yes`` in any case;
- ``bytes``: bytes, bytearrays and strings (UTF-8 encoded);
- :func:`dict_of` (key type, value type), and a :class:`Record` dataclass.

Keys not covered by any schema are accepted or rejected by ``allow_extra_keys``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, Mapping, Optional

from hivemind_tpu_torch.dht.routing import DHTID
from hivemind_tpu_torch.dht.validation import DHTRecord, RecordValidatorBase
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)

FieldType = Callable[[Any], Any]

_INT_STRING = re.compile(r"[+-]?\d(?:_?\d)*(?:\.0+)?", re.ASCII)
_TRUE_STRINGS = frozenset({"1", "on", "t", "true", "y", "yes"})
_FALSE_STRINGS = frozenset({"0", "off", "f", "false", "n", "no"})


def _text(value: Any) -> Optional[str]:
    if isinstance(value, (bytes, bytearray)):
        try:
            return bytes(value).decode("utf-8")
        except UnicodeDecodeError:
            return None
    return value if isinstance(value, str) else None


def lax_int(value: Any) -> int:
    if isinstance(value, int):  # bool included: True is 1
        return int(value)
    if isinstance(value, float):
        if math.isfinite(value) and value.is_integer():
            return int(value)
        raise ValueError(f"{value!r} is not a whole number")
    text = _text(value)
    if text is not None and _INT_STRING.fullmatch(text.strip()):
        return int(text.strip().split(".")[0])
    raise ValueError(f"{value!r} is not a valid integer")


def lax_float(value: Any) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    text = _text(value)
    if text is not None and text.isascii():
        try:
            return float(text)
        except ValueError:
            pass
    raise ValueError(f"{value!r} is not a valid number")


def lax_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    text = _text(value)
    if text is not None:
        if text.lower() in _TRUE_STRINGS:
            return True
        if text.lower() in _FALSE_STRINGS:
            return False
    raise ValueError(f"{value!r} is not a valid boolean")


def lax_bytes(value: Any) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, str):
        return value.encode("utf-8")
    raise ValueError(f"{value!r} is not valid bytes")


LAX_TYPES: Dict[Any, FieldType] = {int: lax_int, float: lax_float, bool: lax_bool, bytes: lax_bytes}
LAX_TYPES.update({kind.__name__: coerce for kind, coerce in list(LAX_TYPES.items())})  # string annotations


class Record:
    """A dataclass base whose fields are validated as pydantic validates a model:
    ``model_validate(mapping)`` coerces each declared field with its lax type (extra
    keys are ignored, a missing one is an error) and then runs ``check()``;
    ``model_dump()`` gives the fields as a dict in declaration order."""

    def __post_init__(self):
        for field in dataclasses.fields(self):
            setattr(self, field.name, LAX_TYPES[field.type](getattr(self, field.name)))
        self.check()

    def check(self) -> None:
        """Raise ``ValueError`` if the coerced values break a rule of the record."""

    @classmethod
    def model_validate(cls, value: Any):
        if isinstance(value, cls):
            return value
        if not isinstance(value, Mapping):
            raise ValueError(f"{cls.__name__} expects a mapping, got {type(value).__name__}")
        names = [field.name for field in dataclasses.fields(cls)]
        missing = [name for name in names if name not in value]
        if missing:
            raise ValueError(f"{cls.__name__}: missing fields {missing}")
        return cls(**{name: value[name] for name in names})

    def model_dump(self) -> dict:
        return {field.name: getattr(self, field.name) for field in dataclasses.fields(self)}

    def model_copy(self, update: Optional[dict] = None):
        return dataclasses.replace(self, **(update or {}))


@dataclasses.dataclass(frozen=True)
class DictOf:
    """A ``Dict[key_type, value_type]`` field: a mapping whose keys and values pass
    their types."""

    key_type: FieldType
    value_type: FieldType

    def __call__(self, value: Any) -> dict:
        if not isinstance(value, Mapping):
            raise ValueError(f"expected a mapping, got {type(value).__name__}")
        return {self.key_type(key): self.value_type(item) for key, item in value.items()}


def dict_of(key_type: FieldType, value_type: Any) -> DictOf:
    value_type = value_type.model_validate if isinstance(value_type, type) and issubclass(value_type, Record) else value_type
    return DictOf(LAX_TYPES.get(key_type, key_type), LAX_TYPES.get(value_type, value_type))


def conbytes(*, regex: Optional[bytes] = None) -> FieldType:
    """A bytes type constrained by a regex: the value must already be bytes (as the
    JAX package's ``BeforeValidator`` requires) and match it in full."""
    pattern = re.compile(regex) if regex is not None else None

    def _validate(value: Any) -> bytes:
        if not isinstance(value, bytes):
            raise ValueError(f"expected bytes, got {type(value)}")
        if pattern is not None and not pattern.fullmatch(value):
            raise ValueError("bytes do not match the required pattern")
        return value

    return _validate


BytesWithEd25519PublicKey = conbytes(regex=rb".*\[owner:.+\].*")


class SchemaValidator(RecordValidatorBase):
    """Validates the records of the keys that ``schema`` names: ``schema`` maps a key
    name to its type (a :func:`dict_of` type validates each subkey's entry)."""

    def __init__(self, schema: Mapping[str, FieldType], allow_extra_keys: bool = True, prefix: Optional[str] = None):
        self._patterns_to_models: Dict[re.Pattern, tuple] = {}
        self._allow_extra_keys = allow_extra_keys
        for field_name, field_type in schema.items():
            key_name = f"{prefix}_{field_name}" if prefix is not None else field_name
            key_id = DHTID.generate(source=key_name).to_bytes()
            # a protected key may carry an [owner:…] suffix appended to the hashed id
            pattern = re.compile(re.escape(key_id.hex()) + r"(.*)?")
            self._patterns_to_models[pattern] = (field_type, isinstance(field_type, DictOf), key_name)

    def validate(self, record: DHTRecord) -> bool:
        models = [
            (model, is_dict, name)
            for pattern, (model, is_dict, name) in self._patterns_to_models.items()
            if pattern.fullmatch(record.key.hex())
        ]
        if not models:
            if not self._allow_extra_keys:
                logger.debug(f"record key {record.key.hex()[:16]}… matches no schema")
            return self._allow_extra_keys
        try:
            value = MSGPackSerializer.loads(record.value)
        except Exception:
            logger.debug("schema validation: value is not valid msgpack")
            return False
        for model, is_dict, name in models:
            try:
                if is_dict and record.subkey:
                    model({MSGPackSerializer.loads(record.subkey): value})
                else:
                    model(value)
                return True
            except (ValueError, TypeError) as e:
                logger.debug(f"schema validation failed for key {name}: {e}")
        return False

    @property
    def priority(self) -> int:
        return 1  # runs beneath signature validators (on already-stripped values)

    def merge_with(self, other: RecordValidatorBase) -> bool:
        if not isinstance(other, SchemaValidator):
            return False
        self._patterns_to_models.update(other._patterns_to_models)
        self._allow_extra_keys = self._allow_extra_keys or other._allow_extra_keys
        return True
