"""A dictionary with value expiration times, the storage primitive beneath the DHT,
its caches and blacklists, and swarm time (the port's copy of
hivemind_tpu/utils/timed_storage.py).
"""

from __future__ import annotations

import heapq
import time
from contextlib import contextmanager
from typing import Generic, Iterator, NamedTuple, Optional, Tuple, TypeVar

KeyType = TypeVar("KeyType")
ValueType = TypeVar("ValueType")

DHTExpiration = float
MAX_DHT_TIME_DISCREPANCY_SECONDS = 3.0  # max tolerated clock skew between peers

# swappable swarm-time source: None = wall clock. A simulator or a test installs
# a virtual clock here so every expiration, declaration window and blacklist
# backoff in the process tracks it. A module-global (not monkeypatching
# get_dht_time itself) because callers across the tree bound the function
# object at import time.
_dht_time_source = None


def set_dht_time_source(source) -> None:
    """Install a ``() -> float`` swarm-time source, or None to restore wall time."""
    global _dht_time_source
    _dht_time_source = source


def get_dht_time() -> DHTExpiration:
    """Global swarm time. Approximated as local UNIX time; peers tolerate up to
    MAX_DHT_TIME_DISCREPANCY_SECONDS of skew."""
    if _dht_time_source is not None:
        return _dht_time_source()
    return time.time()


class ValueWithExpiration(NamedTuple):
    # generic-NamedTuple multiple inheritance requires py3.11; on 3.10 the class
    # stays a plain NamedTuple and subscription (ValueWithExpiration[T]) is a no-op
    value: "ValueType"  # type: ignore[valid-type]
    expiration_time: DHTExpiration

    __class_getitem__ = classmethod(lambda cls, _item: cls)  # type: ignore[assignment]

    def __eq__(self, other):
        if isinstance(other, ValueWithExpiration):
            return self.value == other.value and self.expiration_time == other.expiration_time
        if isinstance(other, tuple):
            return tuple(self) == other
        return False

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.value, self.expiration_time))


class _HeapEntry(NamedTuple):
    expiration_time: DHTExpiration
    key: "KeyType"  # type: ignore[valid-type]

    __class_getitem__ = classmethod(lambda cls, _item: cls)  # type: ignore[assignment]


class TimedStorage(Generic[KeyType, ValueType]):
    """A dict that evicts expired values lazily and the soonest-to-expire value when
    over ``maxsize``. ``freeze()`` suspends eviction for consistent multi-step reads."""

    frozen = False  # class-level default; instances toggle via freeze()

    def __init__(self, maxsize: Optional[int] = None):
        self.maxsize = maxsize
        self._data: dict[KeyType, ValueWithExpiration[ValueType]] = {}
        self._expiration_heap: list[_HeapEntry[KeyType]] = []

    def _remove_outdated(self) -> None:
        if self.frozen:
            return
        now = get_dht_time()
        while self._expiration_heap:
            entry = self._expiration_heap[0]
            current = self._data.get(entry.key)
            if current is not None and current.expiration_time == entry.expiration_time:
                # live heap entry: evict only if expired or oversize
                if entry.expiration_time > now and not (
                    self.maxsize is not None and len(self._data) > self.maxsize
                ):
                    break
                del self._data[entry.key]
            heapq.heappop(self._expiration_heap)

    def store(self, key: KeyType, value: ValueType, expiration_time: DHTExpiration) -> bool:
        """Store (key, value) until expiration_time, unless a fresher value exists.
        Returns True if stored."""
        if expiration_time < get_dht_time() and not self.frozen:
            return False
        previous = self._data.get(key)
        if previous is not None and previous.expiration_time > expiration_time:
            return False
        self._data[key] = ValueWithExpiration(value, expiration_time)
        heapq.heappush(self._expiration_heap, _HeapEntry(expiration_time, key))
        self._remove_outdated()
        return True

    def get(self, key: KeyType) -> Optional[ValueWithExpiration[ValueType]]:
        self._remove_outdated()
        return self._data.get(key)

    def items(self) -> Iterator[Tuple[KeyType, ValueWithExpiration[ValueType]]]:
        self._remove_outdated()
        return iter(self._data.items())

    def top(self) -> Optional[Tuple[KeyType, ValueWithExpiration[ValueType]]]:
        """The entry with the soonest expiration, or None."""
        self._remove_outdated()
        while self._expiration_heap:
            entry = self._expiration_heap[0]
            current = self._data.get(entry.key)
            if current is not None and current.expiration_time == entry.expiration_time:
                return entry.key, current
            heapq.heappop(self._expiration_heap)
        return None

    def __contains__(self, key: KeyType) -> bool:
        self._remove_outdated()
        return key in self._data

    def __len__(self) -> int:
        self._remove_outdated()
        return len(self._data)

    def __delitem__(self, key: KeyType) -> None:
        self._remove_outdated()
        del self._data[key]
        # stale heap entries are pruned lazily

    def __bool__(self) -> bool:
        return len(self) > 0

    @contextmanager
    def freeze(self):
        """Within this context, no values are evicted (consistent reads across awaits)."""
        previous, self.frozen = self.frozen, True
        try:
            yield self
        finally:
            self.frozen = previous

    def __repr__(self) -> str:
        return f"{type(self).__name__}({len(self._data)} items, maxsize={self.maxsize})"
