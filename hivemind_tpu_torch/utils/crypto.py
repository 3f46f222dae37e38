"""Ed25519 keys for peer identity and signed handshakes (the port's copy of
hivemind_tpu/utils/crypto.py), on the libcrypto shim (``utils/_libcrypto.py``)
on every machine. Signatures are base64 text of the 64-byte Ed25519 signature,
as the JAX package writes them. The JAX package's RSA keys have no caller in
either package and are not copied."""

from __future__ import annotations

import base64
import binascii
import threading
from abc import ABC, abstractmethod
from typing import Optional

from hivemind_tpu_torch.utils import _libcrypto


class PrivateKeyBase(ABC):
    @abstractmethod
    def sign(self, data: bytes) -> bytes: ...

    @abstractmethod
    def get_public_key(self) -> "PublicKeyBase": ...

    @abstractmethod
    def to_bytes(self) -> bytes: ...


class PublicKeyBase(ABC):
    @abstractmethod
    def verify(self, data: bytes, signature: bytes) -> bool: ...

    @abstractmethod
    def to_bytes(self) -> bytes: ...


class Ed25519PrivateKey(PrivateKeyBase):
    _process_wide: Optional["Ed25519PrivateKey"] = None
    _process_wide_lock = threading.Lock()

    def __init__(self, key: Optional[_libcrypto.Ed25519PrivateKey] = None):
        self._key = key if key is not None else _libcrypto.Ed25519PrivateKey.generate()

    def sign(self, data: bytes) -> bytes:
        return base64.b64encode(self._key.sign(data))

    def get_public_key(self) -> "Ed25519PublicKey":
        return Ed25519PublicKey(self._key.public_key())

    def to_bytes(self) -> bytes:
        return self._key.private_bytes_raw()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        return cls(_libcrypto.Ed25519PrivateKey.from_private_bytes(data))

    @classmethod
    def process_wide(cls) -> "Ed25519PrivateKey":
        """A singleton key shared by all components in this process (the DHT's
        record signer by default)."""
        with cls._process_wide_lock:
            if cls._process_wide is None:
                cls._process_wide = cls()
            return cls._process_wide

    @classmethod
    def reset_process_wide(cls) -> None:
        with cls._process_wide_lock:
            cls._process_wide = None


class Ed25519PublicKey(PublicKeyBase):
    def __init__(self, key: _libcrypto.Ed25519PublicKey):
        self._key = key

    def verify(self, data: bytes, signature: bytes) -> bool:
        try:
            self._key.verify(base64.b64decode(signature), data)
            return True
        except (_libcrypto.InvalidSignature, ValueError, binascii.Error):
            return False

    def to_bytes(self) -> bytes:
        return self._key.public_bytes_raw()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        return cls(_libcrypto.Ed25519PublicKey.from_public_bytes(data))
