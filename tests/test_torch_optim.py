"""The collaborative optimizer's building blocks against the JAX package: the flax
layout of the ALBERT tree (``convert.to_flax_tree``), the port's optax transforms
against optax step by step, the pydantic-free schema validator and progress records
against pydantic's lax mode (verdicts, coerced values and signed bytes), the PowerSGD
helpers, the state averager's averaged view (names, order, shapes, schema hash) and
checkpoints crossing both ways. Tolerances are stated beside each comparison."""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pydantic
import pytest
import torch

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.dht.crypto import Ed25519SignatureValidator as JaxSignatureValidator
from hivemind_tpu.dht.routing import DHTID as JaxDHTID
from hivemind_tpu.dht.schema import BytesWithEd25519PublicKey as JaxBytesWithKey
from hivemind_tpu.dht.schema import SchemaValidator as JaxSchemaValidator
from hivemind_tpu.dht.validation import DHTRecord as JaxDHTRecord
from hivemind_tpu.models import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models import AlbertForMaskedLM as JaxAlbertForMaskedLM
from hivemind_tpu.moe.server.layers import lamb_with_warmup as jax_lamb_with_warmup
from hivemind_tpu.optim import LocalCheckpointStore as JaxCheckpointStore
from hivemind_tpu.optim import TrainingStateAverager as JaxStateAverager
from hivemind_tpu.optim.chronic import ChronicFailureTracking as JaxChronic
from hivemind_tpu.optim.progress_tracker import LocalTrainingProgress as JaxLocalTrainingProgress
from hivemind_tpu.utils.crypto import Ed25519PrivateKey as JaxEd25519PrivateKey
from hivemind_tpu.utils.math_utils import get_flatten_greedy_dims as jax_greedy_dims
from hivemind_tpu.utils.math_utils import orthogonalize as jax_orthogonalize
from hivemind_tpu.utils.serializer import MSGPackSerializer as JaxMSGPackSerializer
from hivemind_tpu_torch.convert import flax_path, from_flax_albert_params, to_flax_tree
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.dht.crypto import Ed25519SignatureValidator
from hivemind_tpu_torch.dht.routing import DHTID
from hivemind_tpu_torch.dht.schema import BytesWithEd25519PublicKey, SchemaValidator, dict_of
from hivemind_tpu_torch.dht.validation import DHTRecord
from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM
from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
from hivemind_tpu_torch.optim import GradScaler, LocalCheckpointStore, TrainingStateAverager
from hivemind_tpu_torch.optim import transforms as T
from hivemind_tpu_torch.optim.chronic import ChronicFailureTracking
from hivemind_tpu_torch.optim.progress_tracker import LocalTrainingProgress
from hivemind_tpu_torch.utils.crypto import Ed25519PrivateKey
from hivemind_tpu_torch.utils.math_utils import get_flatten_greedy_dims, orthogonalize
from hivemind_tpu_torch.utils.serializer import MSGPackSerializer

EPS32 = 2.0**-23  # float32's ulp at 1


def _tiny_flax_params(seed: int = 0) -> dict:
    """The JAX package's tiny AlbertForMaskedLM tree (fp32), every leaf drawn afresh."""
    rng = np.random.RandomState(seed)
    model = JaxAlbertForMaskedLM(JaxAlbertConfig.tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(lambda x: np.asarray(rng.randn(*np.shape(x)) * 0.3, np.float32), params)


def _keystr(path) -> str:
    """A port tree path in ``jax.tree_util.keystr``'s notation."""
    parts = []
    for key in path:
        if isinstance(key, T.DictKey):
            parts.append(f"[{key.key!r}]")
        elif isinstance(key, T.SequenceKey):
            parts.append(f"[{key.idx}]")
        else:
            parts.append(f".{key.name}")
    return "".join(parts)


# ------------------------------------------------------------------ the flax layout


def test_to_flax_tree_round_trips_the_full_albert_tree():
    """Every leaf of the tiny ALBERT tree comes back under its flax name with its bytes:
    the word embedding as an untransposed ``embedding``, kernels as ``[in, out]``."""
    params = _tiny_flax_params()
    tree = to_flax_tree(from_flax_albert_params(params))
    theirs = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    ours = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert [jax.tree_util.keystr(k) for k in ours] == [jax.tree_util.keystr(k) for k in theirs]
    assert "['word_embeddings']['embedding']" in map(jax.tree_util.keystr, ours)
    for (path, mine), reference in zip(ours.items(), theirs.values()):
        assert mine.shape == reference.shape and mine.tobytes() == np.asarray(reference).tobytes(), path
    # the port model's own parameters give the same tree
    model = AlbertForMaskedLM(AlbertConfig.tiny(dtype=torch.float32))
    model.load_state_dict(from_flax_albert_params(params))
    named = to_flax_tree(dict(model.named_parameters()))
    assert jax.tree_util.tree_structure(named) == jax.tree_util.tree_structure(params)


def test_an_unknown_embedding_table_is_refused_not_transposed():
    """A 2-D weight of an embedding module the converter does not know (Llama's
    ``embed_tokens``) raises, where a Dense kernel's rule would transpose it."""
    with pytest.raises(KeyError, match="EMBEDDING_MODULES"):
        to_flax_tree({"model.embed_tokens.weight": torch.zeros(8, 4)})
    assert flax_path("model.embed_tokens.bias", 1) == (("model", "embed_tokens", "bias"), False)
    assert flax_path("encoder.word_embeddings.weight", 2) == (("encoder", "word_embeddings", "embedding"), False)
    assert flax_path("encoder.query.weight", 2) == (("encoder", "query", "kernel"), True)


# ------------------------------------------------------------------ transforms against optax


def _schedules(lib):
    return lib.join_schedules([lib.linear_schedule(0.0, 0.1, 2), lib.constant_schedule(0.05)], [2])


OPTIMIZERS = {
    "sgd": lambda lib: lib.sgd(0.1),
    "sgd_momentum": lambda lib: lib.sgd(0.1, momentum=0.9),
    "sgd_nesterov": lambda lib: lib.sgd(0.1, momentum=0.9, nesterov=True),
    "adam": lambda lib: lib.adam(1e-2),
    "adamw": lambda lib: lib.adamw(1e-2),
    "adam_joined_schedule": lambda lib: lib.adam(_schedules(lib)),
    "lamb": lambda lib: lib.lamb(1e-2, weight_decay=1e-2),
    "clipped_adamw": lambda lib: lib.chain(lib.clip_by_global_norm(1.0), lib.adamw(1e-3)),
    "lamb_with_warmup": lambda lib: (jax_lamb_with_warmup if lib is optax else lamb_with_warmup)(1e-2, 2, 10),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_transform_matches_optax_over_five_steps(name):
    """The same seeded gradients through optax and the port's transforms, 5 steps at
    fp32 on the tiny ALBERT tree: the state's leaf paths, dtypes and shapes are equal,
    the count leaves equal, and every float (state, updates, parameters) within 8 ulps
    of its leaf's largest magnitude (the gap of a reordered sum)."""
    rng = np.random.RandomState(1)
    params = _tiny_flax_params()
    theirs, ours = OPTIMIZERS[name](optax), OPTIMIZERS[name](T)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    port_params = T.tree_map(lambda x: torch.from_numpy(np.array(x)), params)
    jax_state, port_state = theirs.init(jax_params), ours.init(port_params)
    initial = port_params
    for step in range(5):
        scale = 3.0 if step % 2 else 0.01  # both sides of the clipping norm
        grads = jax.tree_util.tree_map(lambda x: np.asarray(rng.randn(*np.shape(x)) * scale, np.float32), params)
        jax_updates, jax_state = theirs.update(jax.tree_util.tree_map(jnp.asarray, grads), jax_state, jax_params)
        jax_params = optax.apply_updates(jax_params, jax_updates)
        port_updates, port_state = ours.update(T.tree_map(torch.from_numpy, grads), port_state, port_params)
        port_params = T.apply_updates(port_params, port_updates)

        jax_leaves = jax.tree_util.tree_flatten_with_path((jax_state, jax_updates, jax_params))[0]
        port_leaves = T.tree_flatten_with_path((port_state, port_updates, port_params))
        assert [jax.tree_util.keystr(p) for p, _ in jax_leaves] == [_keystr(p) for p, _ in port_leaves]
        for (path, expected), (_, got) in zip(jax_leaves, port_leaves):
            expected, got = np.asarray(expected), got.numpy()
            assert got.dtype == expected.dtype and got.shape == expected.shape, jax.tree_util.keystr(path)
            if expected.dtype.kind != "f":
                assert (got == expected).all(), (step, jax.tree_util.keystr(path))
                continue
            limit = 8 * EPS32 * max(float(np.abs(expected).max()), 1e-30)
            assert np.abs(got - expected).max() <= limit, (step, jax.tree_util.keystr(path))
        if name == "lamb_with_warmup" and step == 0:
            # the schedule reads count 0 before its increment: the first update is exactly 0
            assert all(torch.equal(a, b) for a, b in zip(T.tree_leaves(port_params), T.tree_leaves(initial)))


# ------------------------------------------------------------------ schema and progress records

RECORD = dict(peer_id=b"peer", epoch=3, samples_accumulated=64, samples_per_second=12.5, time=1.7e9, client_mode=False)
FIELD_VALUES = {
    "peer_id": [b"x", "str", "ü", "", bytearray(b"a"), 1, None, 1.5, True],
    "epoch": [0, -1, 1.0, 1.5, True, False, "3", " 3 ", "+3", "1_000", "03", "3.0", "3.0000", "00.000", "3.", ".0",
              "3e0", "-0", "-3", "0x10", "٣", "", " ", "3.50", b"3", b" 3", None, 2**70, float("nan"),
              float("inf"), -0.0, 3.0000000001, [3], {"a": 1}],
    "samples_accumulated": [0, 7, -1, 2.0, "12", True, float("nan"), None],
    "samples_per_second": [0, 1, -1, 0.5, float("nan"), float("inf"), -float("inf"), True, "1.5", " 1.5 ",
                           "1_0.5", "+1", "1e3", "Infinity", "INF", "-inf", "NaN", "nan", "", "0x1p3", ".5",
                           "5.", "1,5", "inf ", b"1.5", None, 2**70, [1.0]],
    "time": [1, 1.5, float("nan"), True, "2", " 2 ", "nan", "-nan", "1e400", None, -5.0, float("inf")],
    "client_mode": [True, False, 0, 1, 2, -1, 0.0, 1.0, 1.5, "true", "false", "yes", "no", "on", "off", "t", "f",
                    "1", "0", "y", "n", "Y", "TrUe", " true", "true ", "", "2", "1.0", "None", b"true", b"1",
                    None, [1]],
}
TABLE = [(field, value) for field, values in FIELD_VALUES.items() for value in values]


def _verdict(model, record):
    try:
        return ("ok", model.model_validate(record).model_dump())
    except (pydantic.ValidationError, ValueError):
        return ("rejected", None)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("field, value", TABLE, ids=[f"{f}={v!r}" for f, v in TABLE])
def test_progress_record_field_table_matches_pydantic_lax_mode(field, value):
    """Each value in each field: the same verdict, and the same coerced value of the
    same type (an int for a float field comes out a float, as pydantic coerces it)."""
    record = dict(RECORD, **{field: value})
    theirs, ours = _verdict(JaxLocalTrainingProgress, record), _verdict(LocalTrainingProgress, record)
    assert theirs[0] == ours[0]
    if theirs[0] == "ok":
        assert list(theirs[1]) == list(ours[1])
        assert all(_same(theirs[1][k], ours[1][k]) for k in theirs[1]), (theirs[1], ours[1])


def test_progress_record_missing_and_extra_fields():
    for name in RECORD:
        partial = {k: v for k, v in RECORD.items() if k != name}
        assert _verdict(JaxLocalTrainingProgress, partial)[0] == _verdict(LocalTrainingProgress, partial)[0] == "rejected"
    extra = dict(RECORD, extra=1)
    assert _verdict(JaxLocalTrainingProgress, extra) == _verdict(LocalTrainingProgress, extra)
    for not_a_record in (None, 3, "x", [1, 2], b"x"):
        assert _verdict(JaxLocalTrainingProgress, not_a_record)[0] == _verdict(LocalTrainingProgress, not_a_record)[0]


def _validators(allow_extra_keys: bool):
    jax_schema = pydantic.create_model(
        "_S", **{"run_progress": (Dict[JaxBytesWithKey, JaxLocalTrainingProgress], ...)})
    return (JaxSchemaValidator(jax_schema, allow_extra_keys=allow_extra_keys),
            SchemaValidator({"run_progress": dict_of(BytesWithEd25519PublicKey, LocalTrainingProgress)},
                            allow_extra_keys=allow_extra_keys))


def test_schema_validators_give_the_jax_verdicts():
    """Records of the progress key (by subkey, or the whole dictionary) and of other
    keys, valid or not: both validators agree on every one, and the port's key ids are
    the JAX package's."""
    key = DHTID.generate(source="run_progress").to_bytes()
    assert key == JaxDHTID.generate(source="run_progress").to_bytes()
    other = DHTID.generate(source="elsewhere").to_bytes()
    owner = b"peer[owner:" + b"k" * 32 + b"]"
    dumps = MSGPackSerializer.dumps
    cases = [
        (key, dumps(owner), dumps(RECORD)),
        (key, dumps(owner), dumps(dict(RECORD, epoch=-1))),
        (key, dumps(owner), dumps(dict(RECORD, epoch="7", client_mode="yes"))),
        (key, dumps(b"no owner marker"), dumps(RECORD)),
        (key, dumps("a str subkey[owner:x]"), dumps(RECORD)),
        (key, dumps(owner), b"\xc1 not msgpack"),
        (key, dumps(owner), dumps({k: v for k, v in RECORD.items() if k != "time"})),
        (key, b"", dumps({owner: RECORD})),
        (key, b"", dumps({b"plain": RECORD})),
        (key, b"", dumps(RECORD)),
        (key + b"[owner:tail]", dumps(owner), dumps(RECORD)),
        (other, b"", dumps("anything")),
    ]
    for allow_extra_keys in (True, False):
        theirs, ours = _validators(allow_extra_keys)
        for record_key, subkey, value in cases:
            verdicts = (theirs.validate(JaxDHTRecord(record_key, subkey, value, 1e10)),
                        ours.validate(DHTRecord(record_key, subkey, value, 1e10)))
            assert verdicts[0] == verdicts[1], (allow_extra_keys, record_key[-8:], subkey, value[:24])


def test_signed_progress_records_are_byte_identical():
    """The same record values and key, signed with the same identity: the stored bytes
    are the same in both packages (msgpack of the record, then the signature)."""
    secret = JaxEd25519PrivateKey()
    theirs = JaxSignatureValidator(secret)
    ours = Ed25519SignatureValidator(Ed25519PrivateKey.from_bytes(secret.to_bytes()))
    assert ours.local_public_key == theirs.local_public_key
    key = DHTID.generate(source="run_progress").to_bytes()
    subkey = MSGPackSerializer.dumps(ours.local_public_key)
    for values in (RECORD, dict(RECORD, samples_per_second=0, time=5, client_mode=1, epoch=2.0)):
        jax_value = JaxMSGPackSerializer.dumps(JaxLocalTrainingProgress(**values).model_dump())
        port_value = MSGPackSerializer.dumps(LocalTrainingProgress(**values).model_dump())
        assert port_value == jax_value
        expiration = 1.7e9 + 60
        assert (ours.sign_value(DHTRecord(key, subkey, port_value, expiration))
                == theirs.sign_value(JaxDHTRecord(key, subkey, jax_value, expiration)))


# ------------------------------------------------------------------ PowerSGD helpers, scaler, chronic


@pytest.mark.parametrize("shape", [(16, 4), (33, 5), (7, 7), (64, 1)])
def test_orthogonalize_is_the_jax_packages_bit_for_bit(shape):
    matrix = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    ours, theirs = orthogonalize(matrix.copy()), jax_orthogonalize(matrix.copy())
    assert ours.tobytes() == theirs.tobytes()


def test_flatten_greedy_dims_agree():
    shapes = [(128, 64), (4, 4, 16), (100,), (3, 5, 7, 2), (0, 4), (1,), (30000, 128), (768, 3072), (12, 64, 64)]
    assert [get_flatten_greedy_dims(s) for s in shapes] == [jax_greedy_dims(s) for s in shapes]


def test_grad_scaler_records_non_finite_gradients():
    scaler = GradScaler()
    assert scaler.unscale_({"w": torch.ones(4)})
    called = []
    scaler.step(lambda: called.append(1))
    assert scaler.unscale_([np.ones(3)]) and not scaler.unscale_({"w": torch.tensor([1.0, float("inf")])})
    scaler.step(lambda: called.append(2))  # skipped
    scaler.update()
    assert called == [1] and not scaler.found_inf and scaler.get_scale() == 1.0


def test_chronic_counter_and_backoff_follow_the_jax_package():
    """The same outcome sequence through both mixins: the same consecutive-failure
    counts, chronic flags and matchmaking delays (backoff capped at 8x and at half the
    averaging timeout)."""

    class Port(ChronicFailureTracking):
        pass

    class Jax(JaxChronic):
        pass

    peers = [Port(), Jax()]
    for peer in peers:
        peer.chronic_failure_threshold, peer.matchmaking_time, peer.averaging_timeout = 3, 2.0, 40.0
        peer._consecutive_failed_rounds = 0
    readings = {id(p): [] for p in peers}
    for outcome in [False, False, None, False, False, False, False, True, False] + [False] * 6:
        for peer in peers:
            peer._record_round_outcome(outcome)
            readings[id(peer)].append((peer.consecutive_failed_averaging_rounds, peer.chronic_averaging_failure,
                                       peer._matchmaking_delay()))
    assert readings[id(peers[0])] == readings[id(peers[1])]


# ------------------------------------------------------------------ the averaged view and checkpoints


@pytest.fixture(scope="module")
def state_averagers():
    """A JAX and a port TrainingStateAverager over the same tiny ALBERT weights and
    ``lamb_with_warmup``, one update apart from their initial state."""
    params = _tiny_flax_params(seed=3)
    jax_dht, dht = JaxDHT(start=True), DHT(start=True)
    theirs = JaxStateAverager(dht=jax_dht, optimizer=jax_lamb_with_warmup(1e-2, 1, 10),
                              params=jax.tree_util.tree_map(jnp.asarray, params), prefix="view")
    model = AlbertForMaskedLM(AlbertConfig.tiny(dtype=torch.float32))
    model.load_state_dict(from_flax_albert_params(params))
    ours = TrainingStateAverager(dht=dht, optimizer=lamb_with_warmup(1e-2, 1, 10),
                                 params=dict(model.named_parameters()), prefix="view")
    grads = jax.tree_util.tree_map(lambda x: np.asarray(np.random.RandomState(4).randn(*x.shape), np.float32), params)
    theirs.apply_optimizer_step(jax.tree_util.tree_map(jnp.asarray, grads))
    ours.apply_optimizer_step(from_flax_albert_params(grads))
    yield theirs, ours, model
    for averager in (ours, theirs):
        averager.shutdown()
    dht.shutdown()
    jax_dht.shutdown()


def test_averaged_view_is_the_jax_packages(state_averagers):
    """Parameters then mu and nu in the JAX package's flatten order and flax layout:
    equal shapes everywhere, parameters and statistics within 8 ulps of each leaf's
    largest magnitude after one update (the update's reordered sums), the same schema
    hash, and two count leaves at 1."""
    theirs, ours, _ = state_averagers
    jax_view, port_view = theirs._host_state_tensors(), ours._host_state_tensors()
    n = len(jax.tree_util.tree_leaves(theirs.params))
    assert len(port_view) == len(jax_view) == 3 * n
    for index, (expected, got) in enumerate(zip(jax_view, port_view)):
        assert got.shape == expected.shape and got.dtype == expected.dtype == np.float32, index
        assert np.abs(got - expected).max() <= 8 * EPS32 * max(float(np.abs(expected).max()), 1e-30), index
    assert ours.schema_hash == theirs.schema_hash
    assert ours._get_opt_counts() == theirs._get_opt_counts() == [1, 1]
    paths = [_keystr(p) for p, leaf in T.tree_flatten_with_path(ours.opt_state) if leaf.ndim == 0]
    assert paths == ["[1][0].count", "[1][3].count"]


def test_checkpoints_restore_in_the_other_package(state_averagers, tmp_path):
    """A checkpoint written by either package's store restores in the other: the
    epoch, the count leaves and every tensor's bytes."""
    theirs, ours, model = state_averagers
    for writer, reader_store, reader, label in (
        (ours, JaxCheckpointStore, theirs, "port-to-jax"),
        (theirs, LocalCheckpointStore, ours, "jax-to-port"),
    ):
        writer.local_epoch = 5
        writer_store = (LocalCheckpointStore if writer is ours else JaxCheckpointStore)(tmp_path / label)
        writer_store.save(writer.state_dict())
        state = reader_store(tmp_path / label).load_latest()
        assert state is not None and state["epoch"] == 5
        reader.load_state_dict(state)
        assert reader.local_epoch == 5 and reader._get_opt_counts() == writer._get_opt_counts()
        for got, expected in zip(reader._host_state_tensors(), writer._host_state_tensors()):
            assert got.tobytes() == expected.tobytes(), label
    # the port's parameters are the module's: the restore wrote them in place
    assert model.word_embeddings.weight.detach().numpy().tobytes() == ours._host_state_tensors()[
        ours._order.index("word_embeddings.weight")].tobytes()
