"""The port's DHT against the JAX package's: every ``dht.proto`` message byte for byte
against the generated ``hivemind_tpu.proto.dht_pb2`` (defaults, packed doubles, an
absent and an empty ``peer``, each side parsing the other's bytes), DHTIDs of the
same keys, routing tables fed the same seeded peers, ``DictionaryDHTValue`` bytes,
records signed in one package validated in the other, a beam search over one
seeded synthetic graph, and a mixed swarm of two port and two JAX ``DHT`` peers
storing and getting each way. Each swarm test runs under a wall-clock deadline."""

from __future__ import annotations

import asyncio
import contextlib
import heapq
import random
import signal
import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.dht.crypto import Ed25519SignatureValidator as JaxSignatureValidator
from hivemind_tpu.dht.routing import DHTID as JaxDHTID
from hivemind_tpu.dht.routing import PeerInfo as JaxPeerInfo
from hivemind_tpu.dht.routing import RoutingTable as JaxRoutingTable
from hivemind_tpu.dht.storage import DHTLocalStorage as JaxDHTLocalStorage
from hivemind_tpu.dht.storage import DictionaryDHTValue as JaxDictionaryDHTValue
from hivemind_tpu.dht.traverse import simple_traverse_dht as jax_simple_traverse_dht
from hivemind_tpu.dht.traverse import traverse_dht as jax_traverse_dht
from hivemind_tpu.dht.validation import DHTRecord as JaxDHTRecord
from hivemind_tpu.p2p.peer_id import PeerID as JaxPeerID
from hivemind_tpu.proto import dht_pb2 as jax_pb2
from hivemind_tpu.utils.crypto import Ed25519PrivateKey as JaxEd25519PrivateKey
from hivemind_tpu.utils.serializer import MSGPackSerializer as JaxMSGPackSerializer
from hivemind_tpu_torch.dht import DHT, DHTID, DHTLocalStorage, DictionaryDHTValue, PeerInfo, RoutingTable
from hivemind_tpu_torch.dht.crypto import Ed25519SignatureValidator
from hivemind_tpu_torch.dht.traverse import simple_traverse_dht, traverse_dht
from hivemind_tpu_torch.dht.validation import DHTRecord
from hivemind_tpu_torch.p2p.peer_id import PeerID
from hivemind_tpu_torch.proto import dht_pb2
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

SETTINGS = settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])


@contextlib.contextmanager
def deadline(seconds: float):
    """Fail the test (TimeoutError at the blocked call) after ``seconds`` of wall time."""

    def _expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, _expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


# ------------------------------------------------------------------ dht.proto

doubles = st.floats(allow_nan=False) | st.sampled_from([0.0, -0.0, float("inf"), -float("inf"), 5e-324])
node_info = st.fixed_dictionaries({}, optional={"node_id": st.binary(max_size=40),
                                                "maddrs": st.lists(st.text(max_size=30), max_size=3),
                                                "auth_token": st.binary(max_size=20)})
# a peer is left out, set empty, or set with fields
maybe_peer = st.one_of(st.just(None), st.just({}), node_info)
MESSAGES = ("NodeInfo", "PingRequest", "PingResponse", "StoreRequest", "StoreResponse", "FindRequest", "PeerContact",
            "FindResult", "FindResponse")


@st.composite
def message_fields(draw, name):
    if name == "NodeInfo":
        return draw(node_info)
    if name == "PeerContact":
        return draw(st.fixed_dictionaries({}, optional={"peer_id": st.binary(max_size=40),
                                                        "maddrs": st.lists(st.text(max_size=20), max_size=3)}))
    if name == "FindResult":
        return draw(st.fixed_dictionaries({}, optional={
            "type": st.sampled_from([0, 1, 2]), "value": st.binary(max_size=100), "expiration_time": doubles,
            "nearest_node_ids": st.lists(st.binary(max_size=32), max_size=3),
            "nearest_contacts": st.lists(message_fields("PeerContact"), max_size=3)}))
    optional = {
        "PingRequest": {"validate": st.booleans()},
        "PingResponse": {"dht_time": doubles, "available": st.booleans()},
        "StoreRequest": {"keys": st.lists(st.binary(max_size=32), max_size=3),
                         "subkeys": st.lists(st.binary(max_size=8), max_size=3),
                         "values": st.lists(st.binary(max_size=50), max_size=3),
                         "expiration_time": st.lists(doubles, max_size=4),
                         "in_cache": st.lists(st.booleans(), max_size=4)},
        "StoreResponse": {"store_ok": st.lists(st.booleans(), max_size=4)},
        "FindRequest": {"keys": st.lists(st.binary(max_size=32), max_size=3)},
        "FindResponse": {"results": st.lists(message_fields("FindResult"), max_size=2)},
    }[name]
    fields = draw(st.fixed_dictionaries({}, optional=optional))
    peer = draw(maybe_peer)
    if peer is not None:
        fields["peer"] = peer
    return fields


def build(module, name, fields):
    fields = dict(fields)
    if "peer" in fields:
        fields["peer"] = module.NodeInfo(**fields["peer"])
    if "nearest_contacts" in fields:
        fields["nearest_contacts"] = [module.PeerContact(**contact) for contact in fields["nearest_contacts"]]
    if "results" in fields:
        fields["results"] = [build(module, "FindResult", result) for result in fields["results"]]
    return getattr(module, name)(**fields)


@pytest.mark.parametrize("name", MESSAGES)
@SETTINGS
@given(data=st.data())
def test_every_dht_message_is_byte_identical_both_ways(name, data):
    fields = data.draw(message_fields(name))
    ours, theirs = build(dht_pb2, name, fields), build(jax_pb2, name, fields)
    encoded = theirs.SerializeToString()
    assert ours.SerializeToString() == encoded
    assert ours.ByteSize() == theirs.ByteSize() == len(encoded)
    parsed = getattr(dht_pb2, name).FromString(encoded)
    assert parsed.SerializeToString() == encoded
    assert getattr(jax_pb2, name).FromString(ours.SerializeToString()).SerializeToString() == encoded
    if "peer" in dict(getattr(dht_pb2, name)._FIELDS_BY_NAME):
        assert parsed.HasField("peer") == theirs.HasField("peer") == ("peer" in fields)
        assert parsed.peer.node_id == theirs.peer.node_id  # an absent peer reads as a default one


def test_an_absent_and_an_empty_peer_differ_as_in_protobuf():
    for module in (dht_pb2, jax_pb2):
        absent, empty = module.PingRequest(), module.PingRequest(peer=module.NodeInfo())
        assert absent.SerializeToString() == b"" and empty.SerializeToString() == b"\x0a\x00"
        assert not absent.HasField("peer") and empty.HasField("peer") and absent != empty
        assert absent.peer.node_id == b"" and not absent.HasField("peer")  # reading does not set it
        absent.peer.maddrs.append("/ip4/127.0.0.1/tcp/1")  # setting a field of the default sets it
        assert absent.HasField("peer")
        with pytest.raises(AttributeError):
            empty.peer = module.NodeInfo()
        with pytest.raises(ValueError):
            empty.HasField("validate")  # a proto3 scalar has no presence
    parsed = dht_pb2.FindResponse.FromString(jax_pb2.FindResponse(peer=jax_pb2.NodeInfo()).SerializeToString())
    assert parsed.HasField("peer") and parsed.SerializeToString() == b"\x12\x00"


def test_result_type_enum_and_field_tables_match_the_generated_descriptors():
    from google.protobuf.descriptor import FieldDescriptor

    kinds = {"bytes": FieldDescriptor.TYPE_BYTES, "string": FieldDescriptor.TYPE_STRING,
             "bool": FieldDescriptor.TYPE_BOOL, "enum": FieldDescriptor.TYPE_ENUM,
             "message": FieldDescriptor.TYPE_MESSAGE, "double": FieldDescriptor.TYPE_DOUBLE}
    assert set(dht_pb2.DESCRIPTOR.message_types_by_name) == set(jax_pb2.DESCRIPTOR.message_types_by_name)
    for name, descriptor in jax_pb2.DESCRIPTOR.message_types_by_name.items():
        theirs = [(f.name, f.number, f.type, f.message_type.name if f.message_type else None) for f in descriptor.fields]
        ours = [(f.name, f.number, kinds[f.type], f.message_type.__name__ if f.message_type else None)
                for f in dht_pb2.DESCRIPTOR.message_types_by_name[name].FIELDS]
        assert ours == theirs, name
    enum_type = jax_pb2.DESCRIPTOR.enum_types_by_name["ResultType"]
    assert dht_pb2.ResultType.items() == [(v.name, v.number) for v in enum_type.values]
    assert (dht_pb2.NOT_FOUND, dht_pb2.FOUND_REGULAR, dht_pb2.FOUND_DICTIONARY) == (
        jax_pb2.NOT_FOUND, jax_pb2.FOUND_REGULAR, jax_pb2.FOUND_DICTIONARY)


# ------------------------------------------------------------------ ids, routing, storage

def _seeded_keys(seed: int):
    rng = random.Random(seed)
    word = lambda: "".join(rng.choice("abcxyz.|[]") for _ in range(rng.randint(0, 12)))  # noqa: E731
    return {
        "str": [word() for _ in range(20)],
        "bytes": [rng.randbytes(rng.randint(0, 40)) for _ in range(20)],
        "int": [rng.randint(-(2**63), 2**64 - 1) for _ in range(20)] + [0, 1, -1, 127, 128, -33],
        "tuple": [(word(), rng.randint(0, 999)) for _ in range(20)],
        "nested": [{"uid": word(), "span": [word(), (rng.random(), b"x")], "n": rng.randint(0, 9)} for _ in range(20)],
    }


@pytest.mark.parametrize("kind", ["str", "bytes", "int", "tuple", "nested"])
def test_dht_ids_of_the_same_keys_are_equal_across_packages(kind):
    for key in _seeded_keys(7)[kind]:
        ours, theirs = DHTID.generate(source=key), JaxDHTID.generate(source=key)
        assert int(ours) == int(theirs) and ours.to_bytes() == theirs.to_bytes(), key
        assert MSGPackSerializer.dumps(key) == JaxMSGPackSerializer.dumps(key)


@pytest.mark.parametrize("bucket_size", [2, 4, 20])
def test_routing_tables_fed_the_same_peers_agree(bucket_size):
    rng = random.Random(bucket_size)
    own = rng.getrandbits(256)
    ours, theirs = RoutingTable(DHTID(own), bucket_size=bucket_size), JaxRoutingTable(JaxDHTID(own), bucket_size)
    ping_requests = []
    for index in range(300):
        node, peer_bytes = rng.getrandbits(256), rng.randbytes(34)
        maddr = (f"/ip4/127.0.0.1/tcp/{1000 + index}",)
        if index % 7 == 3 and len(ours):  # a removal now and then, of a node both know
            victim = sorted(ours.uid_to_info)[rng.randrange(len(ours))]
            ours.remove_node(DHTID(victim))
            theirs.remove_node(JaxDHTID(victim))
        ping_ours = ours.add_or_update_node(DHTID(node), PeerInfo(PeerID(peer_bytes), maddr))
        ping_theirs = theirs.add_or_update_node(JaxDHTID(node), JaxPeerInfo(JaxPeerID(peer_bytes), maddr))
        assert (ping_ours is None) == (ping_theirs is None)
        if ping_ours is not None:
            assert int(ping_ours[0]) == int(ping_theirs[0])
            ping_requests.append(int(ping_ours[0]))
    assert [(b.lower, b.upper, list(map(int, b.nodes_to_peers)), list(map(int, b.replacement_nodes)))
            for b in ours.buckets] == [
        (b.lower, b.upper, list(map(int, b.nodes_to_peers)), list(map(int, b.replacement_nodes)))
        for b in theirs.buckets]
    for _ in range(20):
        query = rng.getrandbits(256)
        exclude = rng.choice(sorted(ours.uid_to_info))
        got = ours.get_nearest_neighbors(DHTID(query), 7, exclude=DHTID(exclude))
        want = theirs.get_nearest_neighbors(JaxDHTID(query), 7, exclude=JaxDHTID(exclude))
        assert [(int(n), info.peer_id.to_bytes(), info.maddrs) for n, info in got] == [
            (int(n), info.peer_id.to_bytes(), info.maddrs) for n, info in want]
    assert bucket_size == 20 or ping_requests  # small buckets fill and ask for liveness pings


def test_dictionary_values_and_local_storage_match_the_jax_package():
    now = get_dht_time()
    ours, theirs = DictionaryDHTValue(maxsize=5), JaxDictionaryDHTValue(maxsize=5)
    for index, subkey in enumerate(["a", 7, ("t", 1), b"raw", "a"]):
        assert ours.store(subkey, f"v{index}".encode(), now + 10 + index) == theirs.store(
            subkey, f"v{index}".encode(), now + 10 + index)
    assert ours.packb() == theirs.packb() and ours.packb_as_dict() == theirs.packb_as_dict()
    assert MSGPackSerializer.dumps(ours) == JaxMSGPackSerializer.dumps(theirs)
    restored = MSGPackSerializer.loads(JaxMSGPackSerializer.dumps(theirs))
    assert isinstance(restored, DictionaryDHTValue) and restored == ours
    assert restored.latest_expiration_time == theirs.latest_expiration_time

    # local storage: the same refusals for the same sequence of stores
    key = DHTID.generate(source="k")
    their_key = JaxDHTID.generate(source="k")
    port_storage, jax_storage = DHTLocalStorage(), JaxDHTLocalStorage()
    script = [("plain", b"p1", now + 5), ("sub", ("s", b"d1"), now + 4), ("sub", ("s", b"d2"), now + 6),
              ("plain", b"p2", now + 5), ("plain", b"p3", now + 9), ("plain", b"old", now - 1)]
    for kind, value, expiration in script:
        if kind == "plain":
            results = port_storage.store(key, value, expiration), jax_storage.store(their_key, value, expiration)
        else:
            results = (port_storage.store_subkey(key, *value, expiration),
                       jax_storage.store_subkey(their_key, *value, expiration))
        assert results[0] == results[1], (kind, value, expiration)
    assert port_storage.get(key) == jax_storage.get(their_key)


def test_signed_records_validate_across_packages_and_tampering_is_refused():
    ours = Ed25519SignatureValidator(Ed25519PrivateKey())
    theirs = JaxSignatureValidator(JaxEd25519PrivateKey())
    expiration = get_dht_time() + 30
    for signer, checker, checker_record in ((ours, theirs, JaxDHTRecord), (theirs, ours, DHTRecord)):
        record_type = DHTRecord if signer is ours else JaxDHTRecord
        key = b"owned" + signer.local_public_key
        value = MSGPackSerializer.dumps({"rate": 1.5})
        signed = signer.sign_value(record_type(key, b"", value, expiration))
        assert signed != value
        good = checker_record(key, b"", signed, expiration)
        assert checker.validate(good) and signer.validate(record_type(key, b"", signed, expiration))
        assert checker.strip_value(good) == value
        for tampered in (checker_record(key, b"", signed.replace(b"\xa4rate", b"\xa4RATE"), expiration),
                         checker_record(key, b"", signed, expiration + 1),
                         checker_record(key, b"", value, expiration)):  # no signature at all
            assert not checker.validate(tampered)
            assert not signer.validate(record_type(*(getattr(tampered, f) for f in
                                                     ("key", "subkey", "value", "expiration_time"))))
        # a subkey owned by the signer, the other place an owner marker may stand
        subkey = MSGPackSerializer.dumps(signer.local_public_key)
        signed = signer.sign_value(record_type(b"open", subkey, value, expiration))
        assert checker.validate(checker_record(b"open", subkey, signed, expiration))


# ------------------------------------------------------------------ traversal

def _fake_swarm(module_ids, routing_table, peer_info, peer_id, num_nodes: int, k: int, seed: int):
    rng = random.Random(seed)
    node_ids = [rng.getrandbits(256) for _ in range(num_nodes)]
    tables = {}
    for node in node_ids:
        table = routing_table(module_ids(node), bucket_size=k)
        for index, other in enumerate(node_ids):
            if other != node:
                table.add_or_update_node(module_ids(other), peer_info(peer_id(index.to_bytes(34, "big")), ()))
        tables[node] = table

    async def get_neighbors(peer, queries):
        await asyncio.sleep(0)
        return {q: ([n for n, _ in tables[int(peer)].get_nearest_neighbors(q, k)], False) for q in queries}

    return [module_ids(node) for node in node_ids], get_neighbors


@pytest.mark.parametrize("k,seed", [(60, 0), (8, 3)])
async def test_beam_search_finds_the_same_nodes_as_the_jax_package(k, seed):
    ours_ids, ours_get = _fake_swarm(DHTID, RoutingTable, PeerInfo, PeerID, 60, k, seed)
    theirs_ids, theirs_get = _fake_swarm(JaxDHTID, JaxRoutingTable, JaxPeerInfo, JaxPeerID, 60, k, seed)
    rng = random.Random(seed + 1)
    queries = [rng.getrandbits(256) for _ in range(4)]
    initial = rng.sample(range(60), 3)
    ours, ours_visited = await traverse_dht([DHTID(q) for q in queries], [ours_ids[i] for i in initial], 10,
                                            num_workers=1, queries_per_call=2, get_neighbors=ours_get)
    theirs, theirs_visited = await jax_traverse_dht([JaxDHTID(q) for q in queries], [theirs_ids[i] for i in initial],
                                                    10, num_workers=1, queries_per_call=2, get_neighbors=theirs_get)
    for query in queries:
        assert list(map(int, ours[DHTID(query)])) == list(map(int, theirs[JaxDHTID(query)]))
        assert set(map(int, ours_visited[DHTID(query)])) == set(map(int, theirs_visited[JaxDHTID(query)]))
        simple, _ = await simple_traverse_dht(DHTID(query), [ours_ids[i] for i in initial], 10, ours_get)
        their_simple, _ = await jax_simple_traverse_dht(JaxDHTID(query), [theirs_ids[i] for i in initial], 10,
                                                        theirs_get)
        assert list(map(int, simple)) == list(map(int, their_simple))
        if k == 60:  # full knowledge: the beam search is exact
            assert list(map(int, ours[DHTID(query)])) == heapq.nsmallest(10, map(int, ours_ids),
                                                                         key=lambda n: n ^ query)


# ------------------------------------------------------------------ a mixed swarm

@pytest.fixture(scope="module")
def mixed_swarm():
    """Two port and two JAX DHT peers in one swarm, each JAX peer bootstrapped from a
    port one and the reverse."""
    with deadline(90):
        first = DHT(start=True)
        jax_first = JaxDHT(initial_peers=[str(m) for m in first.get_visible_maddrs()], start=True)
        second = DHT(initial_peers=[str(m) for m in jax_first.get_visible_maddrs()], start=True)
        jax_second = JaxDHT(initial_peers=[str(m) for m in second.get_visible_maddrs()], start=True)
    peers = {"port": (first, second), "jax": (jax_first, jax_second)}
    yield peers
    for dht in (jax_second, second, jax_first, first):
        dht.shutdown()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_mixed_swarm_stores_and_gets_each_way(mixed_swarm, writer, reader):
    with deadline(60):
        store, get = mixed_swarm[writer], mixed_swarm[reader]
        now = get_dht_time()
        tag = f"{writer}->{reader}"
        assert store[0].store(f"plain:{tag}", {"value": [1, 2.5, "x"], "t": (3, b"y")}, now + 30)
        assert store[1].store(f"dict:{tag}", "first", now + 30, subkey="a")
        assert store[0].store(f"dict:{tag}", b"second", now + 31, subkey=("b", 2))
        assert store[1].store(f"short:{tag}", "soon gone", now + 4.0)
        assert not store[0].store(f"expired:{tag}", "late", now - 1)
        for peer in get:
            plain = peer.get(f"plain:{tag}", latest=True)
            assert plain.value == {"value": [1, 2.5, "x"], "t": (3, b"y")} and plain.expiration_time == now + 30
            dictionary = peer.get(f"dict:{tag}", latest=True).value
            assert {k: (v.value, v.expiration_time) for k, v in dictionary.items()} == {
                "a": ("first", now + 30), ("b", 2): (b"second", now + 31)}
            assert peer.get(f"short:{tag}", latest=True).value == "soon gone"
            assert peer.get(f"expired:{tag}", latest=True) is None
        time.sleep(max(0.0, now + 4.5 - get_dht_time()))
        for peer in get:
            assert peer.get(f"short:{tag}", latest=True) is None  # expired everywhere
        # a fresher plain value replaces an older one across packages
        assert get[0].store(f"plain:{tag}", "newer", now + 40)
        assert store[1].get(f"plain:{tag}", latest=True).value == "newer"
