"""Authorization (the port of hivemind_tpu/utils/auth.py), on the port's Ed25519
keys (``utils/crypto.py``) and msgpack.

``TokenAuthorizerBase`` issues signed access tokens; ``AuthRPCWrapper`` wraps a
servicer so every rpc_* call is validated (SERVICER role) or stamped (CLIENT role).
A token is ``msgpack([payload, signature])`` with ``payload = msgpack([client public
key, expiry, 16-byte nonce])``, signed by the authority's Ed25519 key, as the JAX
package writes it, so each package validates the other's tokens. A replayed
token is refused within a ±1 min clock window (a nonce cache), unless it is bound
to the transport-authenticated sender."""

from __future__ import annotations

import os
import threading
from abc import ABC, abstractmethod
from typing import Any, Optional

from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import TimedStorage, get_dht_time

logger = get_logger(__name__)

MAX_CLIENT_SERVICER_TIME_DIFF = 60.0  # seconds: the ±1 minute clock window


class AuthorizationError(RuntimeError):
    pass


class AuthorizerBase(ABC):
    @abstractmethod
    def issue_token(self) -> bytes:
        """Authority-side: create a token for oneself."""

    @abstractmethod
    def get_local_token(self) -> bytes:
        """The token to stamp on outgoing requests."""

    @abstractmethod
    def validate_token(self, token: bytes, sender_peer_id: Optional[Any] = None) -> bool:
        """Check a presented token, optionally bound to the authenticated sender."""


class TokenAuthorizerBase(AuthorizerBase):
    """Signed access tokens bound to a client identity.

    Roles: the AUTHORITY (holds the signing key) grants a token for a specific
    client's transport public key via ``issue_token_for``; a CLIENT holds its granted
    token (``set_access_token``) and stamps outgoing requests; a SERVICER validates
    tokens AND that the authenticated sender matches the identity the token was
    granted to — an intercepted token is useless from any other peer. Subclasses may
    fetch tokens from an external auth service."""

    def __init__(
        self,
        authority_key: Optional[Ed25519PrivateKey] = None,
        local_key: Optional[Ed25519PrivateKey] = None,
        token_lifetime: float = 600.0,
    ):
        self.authority_key = authority_key
        self.authority_public = (
            authority_key.get_public_key() if authority_key is not None else None
        )
        self.local_key = local_key if local_key is not None else Ed25519PrivateKey.process_wide()
        self.token_lifetime = token_lifetime
        self.access_token: Optional[bytes] = None
        self._seen_nonces: TimedStorage[bytes, bool] = TimedStorage(maxsize=100_000)
        self._lock = threading.Lock()

    def set_authority_public_key(self, public_key: Ed25519PublicKey) -> None:
        self.authority_public = public_key

    def set_access_token(self, token: bytes) -> None:
        """Install a token granted by the authority (delivered out-of-band)."""
        try:
            payload, _sig = MSGPackSerializer.loads(token)
            _pub, expiry, _nonce = MSGPackSerializer.loads(payload)
            self._access_token_expiry = float(expiry)
        except Exception:
            self._access_token_expiry = None
        self.access_token = token

    def issue_token_for(self, client_public_key: Ed25519PublicKey) -> bytes:
        """Authority-side: grant a token bound to one client's transport identity."""
        assert self.authority_key is not None, "only the authority can issue tokens"
        payload = MSGPackSerializer.dumps(
            [client_public_key.to_bytes(), get_dht_time() + self.token_lifetime, os.urandom(16)]
        )
        return MSGPackSerializer.dumps([payload, self.authority_key.sign(payload)])

    def issue_token(self) -> bytes:
        """Authority issuing for itself (e.g. the authority is also a peer)."""
        return self.issue_token_for(self.local_key.get_public_key())

    def get_local_token(self) -> bytes:
        """The token this peer stamps on requests: the granted one, or self-issued if
        this peer IS the authority. Raises loudly when the granted token expired
        (silent stamping of a dead token would fail remotely with no local signal)."""
        if self.access_token is not None:
            expiry = getattr(self, "_access_token_expiry", None)
            if expiry is not None and get_dht_time() > expiry:
                raise AuthorizationError("access token expired; obtain a fresh one from the authority")
            return self.access_token
        if self.authority_key is not None:
            return self.issue_token()
        raise AuthorizationError("no access token: call set_access_token() with a granted token")

    def validate_token(self, token: bytes, sender_peer_id: Optional[Any] = None) -> bool:
        """Check signature, expiry, replay — and, when ``sender_peer_id`` is given,
        that the token was granted to that transport identity."""
        if self.authority_public is None:
            logger.warning("no authority public key configured; rejecting token")
            return False
        try:
            payload, signature = MSGPackSerializer.loads(token)
            if not self.authority_public.verify(payload, signature):
                return False
            client_pubkey_bytes, expiry, nonce = MSGPackSerializer.loads(payload)
        except Exception:
            return False
        now = get_dht_time()
        if expiry < now - MAX_CLIENT_SERVICER_TIME_DIFF:
            return False
        if sender_peer_id is not None:
            from hivemind_tpu_torch.p2p.peer_id import PeerID

            try:
                granted_to = PeerID.from_public_key(Ed25519PublicKey.from_bytes(client_pubkey_bytes))
            except Exception:
                return False
            if granted_to != sender_peer_id:
                logger.debug("token granted to a different peer identity; rejected")
                return False
            # identity binding IS the anti-replay mechanism here: the transport
            # authenticated the sender, so the same token may be reused by its owner
            return True
        with self._lock:
            if nonce in self._seen_nonces:
                logger.debug("replayed auth token rejected")
                return False
            self._seen_nonces.store(nonce, True, expiry + MAX_CLIENT_SERVICER_TIME_DIFF)
        return True


class AuthRole:
    CLIENT = "client"
    SERVICER = "servicer"


class AuthRPCWrapper:
    """Wraps a servicer's rpc_* methods: in SERVICER role,
    requests whose ``peer.auth_token`` fails validation are rejected; in CLIENT role,
    outgoing requests get a fresh token stamped into ``peer.auth_token``."""

    def __init__(self, stub_or_servicer: Any, role: str, authorizer: AuthorizerBase):
        self._wrapped = stub_or_servicer
        self._role = role
        self._authorizer = authorizer

    def __getattr__(self, name: str):
        import inspect

        attr = getattr(self._wrapped, name)
        if not name.startswith("rpc_") or not callable(attr):
            return attr
        role, authorizer = self._role, self._authorizer

        def _check_or_stamp(message, context) -> None:
            sender = getattr(context, "remote_id", None)
            if role == AuthRole.SERVICER:
                token = getattr(getattr(message, "peer", None), "auth_token", b"")
                if not authorizer.validate_token(token, sender_peer_id=sender):
                    raise AuthorizationError(f"{name}: missing or invalid access token")
            elif role == AuthRole.CLIENT:
                peer = getattr(message, "peer", None)
                if peer is not None:
                    peer.auth_token = authorizer.get_local_token()

        async def _prepare(request, args):
            """Stream-input RPCs pass an iterator as the first argument: the auth
            check happens EAGERLY on the first message, before the handler runs (an
            empty or stalling stream must not reach the handler unauthenticated)."""
            context = args[0] if args else None
            if hasattr(request, "__aiter__"):
                iterator = request.__aiter__()
                try:
                    first_message = await iterator.__anext__()
                except StopAsyncIteration:
                    raise AuthorizationError(f"{name}: empty request stream") from None
                _check_or_stamp(first_message, context)

                async def chained():
                    yield first_message
                    async for message in iterator:
                        yield message

                return chained()
            _check_or_stamp(request, context)
            return request

        if inspect.isasyncgenfunction(attr):

            async def stream_wrapped(request, *args, **kwargs):
                request = await _prepare(request, args)
                async for item in attr(request, *args, **kwargs):
                    yield item

            return stream_wrapped

        async def wrapped(request, *args, **kwargs):
            request = await _prepare(request, args)
            result = attr(request, *args, **kwargs)
            if hasattr(result, "__aiter__"):
                # a stub's stream-output caller returns an async iterator, not a coroutine
                return result
            return await result

        return wrapped
