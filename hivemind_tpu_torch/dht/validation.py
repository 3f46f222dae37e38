"""Record validation (the port's copy of hivemind_tpu/dht/validation.py).

Validators inspect and transform records on store (sign, type-check) and on
retrieval (verify, strip signatures). ``CompositeValidator`` chains several in
priority order.
"""

from __future__ import annotations

import dataclasses
import threading
from abc import ABC, abstractmethod
from typing import Iterable, List


@dataclasses.dataclass(init=True, repr=True, frozen=True)
class DHTRecord:
    key: bytes
    subkey: bytes
    value: bytes
    expiration_time: float


class DHTRecordRequestType:
    POST = "post"  # this node initiates the store
    GET = "get"  # record received from another node


class RecordValidatorBase(ABC):
    """Before storing, ``sign_value`` may extend the value; on every store (local or
    remote), ``validate`` accepts/rejects; ``strip_value`` removes any additions
    before handing values back to the caller."""

    @abstractmethod
    def validate(self, record: DHTRecord) -> bool: ...

    def sign_value(self, record: DHTRecord) -> bytes:
        return record.value

    def strip_value(self, record: DHTRecord) -> bytes:
        return record.value

    @property
    def priority(self) -> int:
        """Validators are applied on store in ascending priority; on strip in
        descending."""
        return 0

    def merge_with(self, other: "RecordValidatorBase") -> bool:
        """Try absorbing another validator of the same kind; True if merged."""
        return False


class CompositeValidator(RecordValidatorBase):
    def __init__(self, validators: Iterable[RecordValidatorBase] = ()):
        self._validators: List[RecordValidatorBase] = []
        self._lock = threading.Lock()
        self.extend(validators)

    def extend(self, validators: Iterable[RecordValidatorBase]) -> None:
        with self._lock:
            for new_validator in validators:
                for existing in self._validators:
                    if existing.merge_with(new_validator):
                        break
                else:
                    self._validators.append(new_validator)
            self._validators.sort(key=lambda v: -v.priority)

    def validate(self, record: DHTRecord) -> bool:
        # validators see the record progressively stripped of higher-priority layers
        for i, validator in enumerate(self._validators):
            if not validator.validate(record):
                return False
            record = dataclasses.replace(record, value=validator.strip_value(record))
        return True

    def sign_value(self, record: DHTRecord) -> bytes:
        for validator in reversed(self._validators):
            record = dataclasses.replace(record, value=validator.sign_value(record))
        return record.value

    def strip_value(self, record: DHTRecord) -> bytes:
        for validator in self._validators:
            record = dataclasses.replace(record, value=validator.strip_value(record))
        return record.value
