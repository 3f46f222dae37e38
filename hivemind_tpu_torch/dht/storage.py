"""Local DHT record storage: plain values and subkey dictionaries with per-subkey
expiration (the port's copy of hivemind_tpu/dht/storage.py). ``DictionaryDHTValue``
is msgpack extension 0x50, as in the JAX package."""

from __future__ import annotations

from typing import Union

from hivemind_tpu_torch.dht.routing import BinaryDHTValue, DHTID, Subkey
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, TimedStorage


@MSGPackSerializer.ext_serializable(0x50)
class DictionaryDHTValue(TimedStorage[Subkey, BinaryDHTValue]):
    """A value that is itself a dictionary of subkey → (value, expiration). Stored
    under one DHT key; merged subkey-by-subkey on conflicting stores."""

    latest_expiration_time: DHTExpiration = -float("inf")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.latest_expiration_time = -float("inf")

    def store(self, key: Subkey, value: BinaryDHTValue, expiration_time: DHTExpiration) -> bool:
        self.latest_expiration_time = max(self.latest_expiration_time, expiration_time)
        return super().store(key, value, expiration_time)

    def packb(self) -> bytes:
        items = [[key, value, expiration] for key, (value, expiration) in self.items()]
        return MSGPackSerializer.dumps([self.maxsize, items])

    def packb_as_dict(self) -> bytes:
        """Wire form used by rpc_find: {subkey: (value, expiration)} via msgpack."""
        return MSGPackSerializer.dumps(
            {key: (value, expiration) for key, (value, expiration) in self.items()}
        )

    @classmethod
    def unpackb(cls, data: bytes) -> "DictionaryDHTValue":
        maxsize, items = MSGPackSerializer.loads(data)
        out = cls(maxsize=maxsize)
        for key, value, expiration in items:
            out.store(key, value, expiration)
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, DictionaryDHTValue):
            return NotImplemented
        return dict(self.items()) == dict(other.items())


class DHTLocalStorage(TimedStorage[DHTID, Union[BinaryDHTValue, DictionaryDHTValue]]):
    """Storage of one DHT peer: plain binary values and subkey dictionaries."""

    def store(
        self, key: DHTID, value: BinaryDHTValue, expiration_time: DHTExpiration
    ) -> bool:
        """Store a plain value. Refuses to overwrite a dictionary with a plain value
        unless the plain value is fresher than everything in it."""
        existing = self.get(key)
        if existing is not None and isinstance(existing.value, DictionaryDHTValue):
            if expiration_time <= existing.value.latest_expiration_time:
                return False
        return super().store(key, value, expiration_time)

    def store_subkey(
        self, key: DHTID, subkey: Subkey, value: BinaryDHTValue, expiration_time: DHTExpiration
    ) -> bool:
        """Add/update one subkey of a dictionary value. A plain value under the same
        key is replaced only if this subkey is fresher."""
        existing = self.get(key)
        if existing is None or not isinstance(existing.value, DictionaryDHTValue):
            if existing is not None and existing.expiration_time >= expiration_time:
                return False  # a fresher plain value wins over the new dictionary entry
            dictionary = DictionaryDHTValue()
            dictionary.store(subkey, value, expiration_time)
            return super().store(key, dictionary, expiration_time)
        dictionary = existing.value
        stored = dictionary.store(subkey, value, expiration_time)
        if stored:
            # re-register the container so the outer expiration tracks the latest subkey
            super().store(key, dictionary, dictionary.latest_expiration_time)
        return stored
