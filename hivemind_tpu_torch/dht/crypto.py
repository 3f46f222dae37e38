"""Signature-protected DHT records (the port's copy of hivemind_tpu/dht/crypto.py).

A key or subkey containing ``[owner:<pubkey>]`` may only be stored with a matching
``[signature:<sig>]`` suffix on the value, signed by that owner with Ed25519 (the
port's ``utils/crypto.py`` keys, on libcrypto). The signed payload is the msgpack
of ``[key, subkey, value, expiration_time]``, byte for byte the JAX package's, so
a record signed by either package validates in the other.
"""

from __future__ import annotations

import base64
import dataclasses
import re
from typing import Optional

from hivemind_tpu_torch.dht.validation import DHTRecord, RecordValidatorBase
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

logger = get_logger(__name__)


class Ed25519SignatureValidator(RecordValidatorBase):
    """Makes protected records editable only by their owner."""

    _owner_marker = b"[owner:"
    _signature_re = re.compile(rb"\[signature:(.*?)\]")

    def __init__(self, private_key: Optional[Ed25519PrivateKey] = None):
        self._private_key = private_key if private_key is not None else Ed25519PrivateKey.process_wide()
        # base64: raw key bytes could contain ']' and break marker extraction
        serialized_public = base64.b64encode(self._private_key.get_public_key().to_bytes())
        self._local_public_key = self._owner_marker + serialized_public + b"]"

    @property
    def local_public_key(self) -> bytes:
        """The marker blob callers embed in keys/subkeys they want to protect."""
        return self._local_public_key

    def validate(self, record: DHTRecord) -> bool:
        public_keys = self._extract_owner_keys(record.key) + self._extract_owner_keys(record.subkey)
        if not public_keys:
            return True  # unprotected record
        signature_match = self._signature_re.search(record.value)
        if signature_match is None:
            logger.debug("protected record has no signature")
            return False
        signature = signature_match.group(1)
        stripped = dataclasses.replace(record, value=self._signature_re.sub(b"", record.value))
        payload = self._record_payload(stripped)
        for serialized_key in public_keys:
            try:
                public_key = Ed25519PublicKey.from_bytes(base64.b64decode(serialized_key))
            except Exception:
                continue
            if public_key.verify(payload, signature):
                return True
        logger.debug("signature verification failed for protected record")
        return False

    def sign_value(self, record: DHTRecord) -> bytes:
        if self._local_public_key not in record.key and self._local_public_key not in record.subkey:
            return record.value
        signature = self._private_key.sign(self._record_payload(record))
        return record.value + b"[signature:" + signature + b"]"

    def strip_value(self, record: DHTRecord) -> bytes:
        return self._signature_re.sub(b"", record.value)

    def _record_payload(self, record: DHTRecord) -> bytes:
        return MSGPackSerializer.dumps(
            [record.key, record.subkey, record.value, record.expiration_time]
        )

    def _extract_owner_keys(self, field: bytes) -> list:
        if not field or self._owner_marker not in field:
            return []
        out = []
        start = 0
        while True:
            idx = field.find(self._owner_marker, start)
            if idx < 0:
                break
            end = field.find(b"]", idx)
            if end < 0:
                break
            out.append(field[idx + len(self._owner_marker) : end])
            start = end + 1
        return out

    @property
    def priority(self) -> int:
        return 10  # signatures wrap everything else (applied last on sign, first on strip)

    def merge_with(self, other: RecordValidatorBase) -> bool:
        # signature validators with different keys coexist: validation tries each owner
        return isinstance(other, Ed25519SignatureValidator) and other._local_public_key == self._local_public_key
