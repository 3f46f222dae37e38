"""The port's token authorization against the JAX package's: tokens issued by either
package's authority validate in the other's servicer, a replayed token is refused
in each, forged, foreign-authority and expired tokens are refused, a token bound to
a peer identity is accepted from that peer only (peer ids cross by bytes), and the
port's ``AuthRPCWrapper`` stamps and checks requests on both sides of an RPC."""

from __future__ import annotations

import pytest

from hivemind_tpu.p2p.peer_id import PeerID as JaxPeerID
from hivemind_tpu.utils.auth import TokenAuthorizerBase as JaxTokenAuthorizerBase
from hivemind_tpu.utils.crypto import Ed25519PrivateKey as JaxEd25519PrivateKey
from hivemind_tpu.utils.crypto import Ed25519PublicKey as JaxEd25519PublicKey
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.proto import dht_pb2
from hivemind_tpu_torch.utils.auth import AuthorizationError, AuthRole, AuthRPCWrapper, TokenAuthorizerBase
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey, Ed25519PublicKey
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

DIRECTIONS = ["jax-issues-port-validates", "port-issues-jax-validates"]


def authority_pair(direction: str):
    """(issuer, validator): an authority in one package, a servicer in the other that
    trusts the authority's public key (carried across by bytes)."""
    if direction == DIRECTIONS[0]:
        authority = JaxEd25519PrivateKey()
        issuer = JaxTokenAuthorizerBase(authority_key=authority, local_key=JaxEd25519PrivateKey())
        validator = TokenAuthorizerBase(local_key=Ed25519PrivateKey())
        validator.set_authority_public_key(Ed25519PublicKey.from_bytes(authority.get_public_key().to_bytes()))
    else:
        authority = Ed25519PrivateKey()
        issuer = TokenAuthorizerBase(authority_key=authority, local_key=Ed25519PrivateKey())
        validator = JaxTokenAuthorizerBase(local_key=JaxEd25519PrivateKey())
        validator.set_authority_public_key(JaxEd25519PublicKey.from_bytes(authority.get_public_key().to_bytes()))
    return issuer, validator


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tokens_validate_across_packages_and_replay_is_refused(direction):
    issuer, validator = authority_pair(direction)
    token = issuer.issue_token()
    payload, _signature = MSGPackSerializer.loads(token)
    public_key, expiry, nonce = MSGPackSerializer.loads(payload)
    assert len(public_key) == 32 and isinstance(expiry, float) and len(nonce) == 16
    assert validator.validate_token(token)
    assert not validator.validate_token(token)  # the same nonce again
    assert validator.validate_token(issuer.issue_token())


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_forged_foreign_and_expired_tokens_are_refused(direction):
    issuer, validator = authority_pair(direction)
    token = issuer.issue_token()
    payload, signature = MSGPackSerializer.loads(token)
    forged_payload = MSGPackSerializer.loads(payload)
    forged_payload[1] += 3600.0  # a longer life under the authority's old signature
    assert not validator.validate_token(MSGPackSerializer.dumps([MSGPackSerializer.dumps(forged_payload), signature]))
    imposter_class = type(issuer)
    imposter_key = JaxEd25519PrivateKey() if imposter_class is JaxTokenAuthorizerBase else Ed25519PrivateKey()
    assert not validator.validate_token(imposter_class(authority_key=imposter_key).issue_token())
    assert not validator.validate_token(b"garbage")
    expired = imposter_class(authority_key=issuer.authority_key, token_lifetime=-120).issue_token()
    assert not validator.validate_token(expired)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_a_bound_token_is_accepted_from_its_peer_only(direction):
    issuer, validator = authority_pair(direction)
    port_side = isinstance(issuer, TokenAuthorizerBase)
    client_key = Ed25519PrivateKey() if port_side else JaxEd25519PrivateKey()
    token = issuer.issue_token_for(client_key.get_public_key())
    peer_class = JaxPeerID if port_side else PeerID  # the validator's package
    key_class = JaxEd25519PublicKey if port_side else Ed25519PublicKey
    client_id = peer_class.from_public_key(key_class.from_bytes(client_key.get_public_key().to_bytes()))
    other_key = (JaxEd25519PrivateKey() if port_side else Ed25519PrivateKey()).get_public_key()
    other_id = peer_class.from_public_key(key_class.from_bytes(other_key.to_bytes()))
    assert validator.validate_token(token, sender_peer_id=client_id)
    assert validator.validate_token(token, sender_peer_id=client_id)  # its owner may reuse it
    assert not validator.validate_token(token, sender_peer_id=other_id)


async def test_auth_rpc_wrapper_stamps_and_checks():
    issuer = TokenAuthorizerBase(authority_key=Ed25519PrivateKey(), local_key=Ed25519PrivateKey())
    validator = TokenAuthorizerBase(local_key=Ed25519PrivateKey())
    validator.set_authority_public_key(issuer.authority_public)

    class Servicer:
        async def rpc_ping(self, request, context):
            return "pong"

        async def rpc_stream(self, requests, context):
            async for request in requests:
                yield request.peer.node_id

    class Stub:
        async def rpc_ping(self, request, context=None):
            return request

    wrapped = AuthRPCWrapper(Servicer(), AuthRole.SERVICER, validator)
    request = dht_pb2.PingRequest(peer=dht_pb2.NodeInfo(node_id=b"x"))
    with pytest.raises(AuthorizationError):
        await wrapped.rpc_ping(request, None)
    stamped = await AuthRPCWrapper(Stub(), AuthRole.CLIENT, issuer).rpc_ping(request)
    assert stamped.peer.auth_token
    assert await wrapped.rpc_ping(stamped, None) == "pong"
    assert not validator.validate_token(stamped.peer.auth_token)  # served once: its nonce is spent

    async def stream(*messages):
        for message in messages:
            yield message

    fresh = dht_pb2.PingRequest(peer=dht_pb2.NodeInfo(node_id=b"y", auth_token=issuer.issue_token()))
    assert [item async for item in wrapped.rpc_stream(stream(fresh, request), None)] == [b"y", b"x"]
    with pytest.raises(AuthorizationError, match="empty request stream"):
        [item async for item in wrapped.rpc_stream(stream(), None)]
