"""The primitives of the port's encrypted transport, on the system's libcrypto
(OpenSSL >= 1.1.1) over ctypes: the port's copy of hivemind_tpu/utils/_libcrypto.py,
used on every machine, so that one code path runs in the tests and on the card.

- Ed25519 keys (raw bytes, sign, verify) for peer identity;
- X25519 key agreement for the handshake's ephemeral keys;
- ChaCha20-Poly1305 (RFC 7539: ciphertext || 16-byte tag), sealing a frame
  given as several buffers without joining them first;
- HKDF-SHA256 (RFC 5869), on ``hmac``/``hashlib``.

libcrypto is loaded at the first use, never at import. If it cannot be loaded,
every use raises :class:`LibcryptoUnavailable`, which names the library: nothing
falls back to plaintext. Each call makes its own EVP context, so the objects are
thread-safe; ctypes releases the GIL during each call, so AEAD calls on several
threads run in parallel.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import hmac
import threading
from typing import Optional, Sequence, Union

import numpy as np

Buffer = Union[bytes, bytearray, memoryview]


class LibcryptoUnavailable(ImportError):
    """The system's libcrypto (OpenSSL >= 1.1.1) could not be loaded."""


class InvalidSignature(Exception):
    pass


class InvalidTag(Exception):
    pass


_EVP_PKEY_X25519 = 1034  # NID_X25519
_EVP_PKEY_ED25519 = 1087  # NID_ED25519
_EVP_CTRL_AEAD_SET_IVLEN = 0x9
_EVP_CTRL_AEAD_GET_TAG = 0x10
_EVP_CTRL_AEAD_SET_TAG = 0x11

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> None:
    vp, sz, ci = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    signatures = {
        "EVP_PKEY_new_raw_private_key": (vp, [ci, vp, ctypes.c_char_p, sz]),
        "EVP_PKEY_new_raw_public_key": (vp, [ci, vp, ctypes.c_char_p, sz]),
        "EVP_PKEY_get_raw_private_key": (ci, [vp, ctypes.c_char_p, ctypes.POINTER(sz)]),
        "EVP_PKEY_get_raw_public_key": (ci, [vp, ctypes.c_char_p, ctypes.POINTER(sz)]),
        "EVP_PKEY_free": (None, [vp]),
        "EVP_PKEY_CTX_new_id": (vp, [ci, vp]),
        "EVP_PKEY_CTX_new": (vp, [vp, vp]),
        "EVP_PKEY_CTX_free": (None, [vp]),
        "EVP_PKEY_keygen_init": (ci, [vp]),
        "EVP_PKEY_keygen": (ci, [vp, ctypes.POINTER(vp)]),
        "EVP_PKEY_derive_init": (ci, [vp]),
        "EVP_PKEY_derive_set_peer": (ci, [vp, vp]),
        "EVP_PKEY_derive": (ci, [vp, ctypes.c_char_p, ctypes.POINTER(sz)]),
        "EVP_MD_CTX_new": (vp, []),
        "EVP_MD_CTX_free": (None, [vp]),
        "EVP_DigestSignInit": (ci, [vp, ctypes.POINTER(vp), vp, vp, vp]),
        "EVP_DigestVerifyInit": (ci, [vp, ctypes.POINTER(vp), vp, vp, vp]),
        "EVP_DigestSign": (ci, [vp, ctypes.c_char_p, ctypes.POINTER(sz), ctypes.c_char_p, sz]),
        "EVP_DigestVerify": (ci, [vp, ctypes.c_char_p, sz, ctypes.c_char_p, sz]),
        "EVP_CIPHER_CTX_new": (vp, []),
        "EVP_CIPHER_CTX_free": (None, [vp]),
        "EVP_chacha20_poly1305": (vp, []),
        "EVP_CipherInit_ex": (ci, [vp, vp, vp, ctypes.c_char_p, ctypes.c_char_p, ci]),
        # void* in and out: each piece of a frame is read and written in place
        "EVP_CipherUpdate": (ci, [vp, vp, ctypes.POINTER(ci), vp, ci]),
        "EVP_CipherFinal_ex": (ci, [vp, vp, ctypes.POINTER(ci)]),
        "EVP_CIPHER_CTX_ctrl": (ci, [vp, ci, ci, vp]),
    }
    for name, (restype, argtypes) in signatures.items():
        function = getattr(lib, name)
        function.restype, function.argtypes = restype, argtypes


def libcrypto() -> ctypes.CDLL:
    """The loaded library, loaded at the first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            candidates = [name for name in (ctypes.util.find_library("crypto"),) if name]
            candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so", "libcrypto.dylib"]
            errors = []
            for name in candidates:
                try:
                    lib = ctypes.CDLL(name)
                    lib.EVP_PKEY_new_raw_private_key  # >= 1.1.1: Ed25519 raw keys
                except (OSError, AttributeError) as e:
                    errors.append(f"{name}: {e}")
                    continue
                _declare(lib)
                _lib = lib
                break
            else:
                raise LibcryptoUnavailable(
                    "the encrypted transport needs libcrypto (OpenSSL >= 1.1.1), which could not be "
                    "loaded: " + "; ".join(errors)
                )
    return _lib


def _check(ok: int, what: str) -> None:
    if ok != 1:
        raise ValueError(f"libcrypto: {what} failed")


def _address(buffer: Buffer) -> int:
    """The address of a bytes-like object's first byte, without a copy (the caller
    keeps the object alive for the call)."""
    return np.frombuffer(buffer, np.uint8).ctypes.data


class _PKey:
    """Owns one EVP_PKEY*."""

    def __init__(self, handle: Optional[int]):
        if not handle:
            raise ValueError("libcrypto returned a NULL EVP_PKEY")
        self._handle = handle

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle and _lib is not None:
            _lib.EVP_PKEY_free(handle)

    @classmethod
    def generate(cls, key_type: int) -> "_PKey":
        lib = libcrypto()
        ctx = lib.EVP_PKEY_CTX_new_id(key_type, None)
        if not ctx:
            raise ValueError(f"libcrypto: no keygen context for type {key_type}")
        try:
            _check(lib.EVP_PKEY_keygen_init(ctx), "keygen_init")
            out = ctypes.c_void_p()
            _check(lib.EVP_PKEY_keygen(ctx, ctypes.byref(out)), "keygen")
            return cls(out.value)
        finally:
            lib.EVP_PKEY_CTX_free(ctx)

    @classmethod
    def from_raw(cls, key_type: int, data: bytes, private: bool) -> "_PKey":
        lib = libcrypto()
        data = bytes(data)
        make = lib.EVP_PKEY_new_raw_private_key if private else lib.EVP_PKEY_new_raw_public_key
        return cls(make(key_type, None, data, len(data)))

    def raw(self, private: bool) -> bytes:
        lib = libcrypto()
        buf = ctypes.create_string_buffer(32)
        size = ctypes.c_size_t(32)
        get = lib.EVP_PKEY_get_raw_private_key if private else lib.EVP_PKEY_get_raw_public_key
        _check(get(self._handle, buf, ctypes.byref(size)), "get_raw_key")
        return buf.raw[: size.value]


# ------------------------------------------------------------------ Ed25519


class Ed25519PrivateKey:
    def __init__(self, pkey: _PKey):
        self._pkey = pkey

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(_PKey.generate(_EVP_PKEY_ED25519))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        return cls(_PKey.from_raw(_EVP_PKEY_ED25519, data, private=True))

    def sign(self, data: bytes) -> bytes:
        lib = libcrypto()
        data = bytes(data)
        mdctx = lib.EVP_MD_CTX_new()
        try:
            _check(lib.EVP_DigestSignInit(mdctx, None, None, None, self._pkey._handle), "DigestSignInit")
            sig = ctypes.create_string_buffer(64)
            siglen = ctypes.c_size_t(64)
            _check(lib.EVP_DigestSign(mdctx, sig, ctypes.byref(siglen), data, len(data)), "DigestSign")
            return sig.raw[: siglen.value]
        finally:
            lib.EVP_MD_CTX_free(mdctx)

    def public_key(self) -> "Ed25519PublicKey":
        return Ed25519PublicKey.from_public_bytes(self._pkey.raw(private=False))

    def private_bytes_raw(self) -> bytes:
        return self._pkey.raw(private=True)


class Ed25519PublicKey:
    def __init__(self, pkey: _PKey):
        self._pkey = pkey

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        return cls(_PKey.from_raw(_EVP_PKEY_ED25519, data, private=False))

    def verify(self, signature: bytes, data: bytes) -> None:
        lib = libcrypto()
        signature, data = bytes(signature), bytes(data)
        mdctx = lib.EVP_MD_CTX_new()
        try:
            _check(lib.EVP_DigestVerifyInit(mdctx, None, None, None, self._pkey._handle), "DigestVerifyInit")
            ok = lib.EVP_DigestVerify(mdctx, signature, len(signature), data, len(data))
        finally:
            lib.EVP_MD_CTX_free(mdctx)
        if ok != 1:
            raise InvalidSignature("Ed25519 signature mismatch")

    def public_bytes_raw(self) -> bytes:
        return self._pkey.raw(private=False)


# ------------------------------------------------------------------ X25519


class X25519PublicKey:
    def __init__(self, pkey: _PKey):
        self._pkey = pkey

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(_PKey.from_raw(_EVP_PKEY_X25519, data, private=False))

    def public_bytes_raw(self) -> bytes:
        return self._pkey.raw(private=False)


class X25519PrivateKey:
    def __init__(self, pkey: _PKey):
        self._pkey = pkey

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(_PKey.generate(_EVP_PKEY_X25519))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "X25519PrivateKey":
        return cls(_PKey.from_raw(_EVP_PKEY_X25519, data, private=True))

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey.from_public_bytes(self._pkey.raw(private=False))

    def exchange(self, peer_public_key: X25519PublicKey) -> bytes:
        lib = libcrypto()
        ctx = lib.EVP_PKEY_CTX_new(self._pkey._handle, None)
        if not ctx:
            raise ValueError("libcrypto: no derive context")
        try:
            _check(lib.EVP_PKEY_derive_init(ctx), "derive_init")
            _check(lib.EVP_PKEY_derive_set_peer(ctx, peer_public_key._pkey._handle), "derive_set_peer")
            out = ctypes.create_string_buffer(32)
            outlen = ctypes.c_size_t(32)
            _check(lib.EVP_PKEY_derive(ctx, out, ctypes.byref(outlen)), "derive")
            return out.raw[: outlen.value]
        finally:
            lib.EVP_PKEY_CTX_free(ctx)


# ------------------------------------------------------------------ ChaCha20-Poly1305


class ChaCha20Poly1305:
    """The AEAD of the encrypted channel. ``encrypt_parts`` seals the
    concatenation of several buffers, each read in place; results are fresh
    ``bytearray`` objects (ciphertext || tag when sealing), written in place by
    libcrypto."""

    TAG_LEN = 16

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    def _run(self, encrypt: bool, nonce: bytes, parts: Sequence[Buffer], tag: Optional[bytes]) -> bytearray:
        lib = libcrypto()
        total = sum(len(part) for part in parts)
        out = bytearray(total + (self.TAG_LEN if encrypt else 0))
        out_address = _address(out) if out else None
        ctx = lib.EVP_CIPHER_CTX_new()
        if not ctx:
            raise ValueError("libcrypto: no cipher context")
        try:
            enc = 1 if encrypt else 0
            _check(lib.EVP_CipherInit_ex(ctx, lib.EVP_chacha20_poly1305(), None, None, None, enc), "CipherInit")
            _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_IVLEN, len(nonce), None), "set_ivlen")
            _check(lib.EVP_CipherInit_ex(ctx, None, None, self._key, bytes(nonce), enc), "CipherInit(key)")
            outlen = ctypes.c_int(0)
            written = 0
            for part in parts:
                if not len(part):
                    continue
                _check(lib.EVP_CipherUpdate(ctx, out_address + written, ctypes.byref(outlen), _address(part),
                                            len(part)), "update")
                written += outlen.value
            if not encrypt:
                tag_buf = ctypes.create_string_buffer(bytes(tag), self.TAG_LEN)
                _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_TAG, self.TAG_LEN, tag_buf), "set_tag")
            final = ctypes.create_string_buffer(16)
            if lib.EVP_CipherFinal_ex(ctx, final, ctypes.byref(outlen)) != 1:
                raise InvalidTag("AEAD authentication failed")
            if encrypt:
                _check(lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_GET_TAG, self.TAG_LEN, out_address + written),
                       "get_tag")
            return out
        finally:
            lib.EVP_CIPHER_CTX_free(ctx)

    def encrypt(self, nonce: bytes, data: Buffer, associated_data: None = None) -> bytearray:
        return self._run(True, nonce, (data,), None)

    def encrypt_parts(self, nonce: bytes, parts: Sequence[Buffer], associated_data: None = None) -> bytearray:
        """Seal a frame whose plaintext is the concatenation of ``parts`` without
        joining them first."""
        return self._run(True, nonce, parts, None)

    def decrypt(self, nonce: bytes, data: Buffer, associated_data: None = None) -> bytearray:
        if len(data) < self.TAG_LEN:
            raise InvalidTag("ciphertext shorter than the AEAD tag")
        view = memoryview(data)
        return self._run(False, nonce, (view[: -self.TAG_LEN],), view[-self.TAG_LEN:])


# ------------------------------------------------------------------ HKDF (RFC 5869, SHA-256)


def hkdf_sha256(key_material: bytes, length: int, salt: Optional[bytes] = None, info: bytes = b"") -> bytes:
    prk = hmac.new(salt or b"\x00" * 32, bytes(key_material), hashlib.sha256).digest()
    okm, block = b"", b""
    counter = 1
    while len(okm) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        okm += block
        counter += 1
    return okm[:length]
