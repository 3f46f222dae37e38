"""The port's slice tier against the JAX package's: a SliceAverager of four gloo ranks
averages with a JAX host peer as one swarm peer; a port SliceOptimizer (four ranks, dp 2
× sp 2) and a JAX Optimizer train one tiny ALBERT to epoch 3 as one large batch; a port
slice's checkpoint loads into JAX's SliceOptimizer and the reverse; and a failure of the
slice's network process raises on every rank."""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from hivemind_tpu.averaging import DecentralizedAverager as JaxAverager
from hivemind_tpu.compression import NoCompression as JaxNoCompression
from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.models import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models import AlbertForMaskedLM as JaxAlbertForMaskedLM
from hivemind_tpu.models import make_mlm_loss_fn as jax_make_mlm_loss_fn
from hivemind_tpu.moe.server.layers import lamb_with_warmup as jax_lamb_with_warmup
from hivemind_tpu.optim import Optimizer as JaxOptimizer
from hivemind_tpu.optim import SliceOptimizer as JaxSliceOptimizer
from hivemind_tpu_torch.parallel.mesh import P

import torch_mesh_ranks as ranks

WORLD, SHAPE = 4, (2, 1, 2)  # dp 2 x sp 2
BATCH, SEQ, TARGET, EPOCHS = 4, 16, 16, 3
LAMB = (1e-2, 1, 100)  # peak lr, warmup epochs, total epochs
LR_AT = [0.0, LAMB[0], LAMB[0] * (1 - 1 / (LAMB[2] - LAMB[1]))]  # the schedule at counts 0, 1, 2


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(WORLD)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def albert():
    config = JaxAlbertConfig.tiny(dtype=jnp.float32, max_position=SEQ)
    model = JaxAlbertForMaskedLM(config)
    rng = np.random.RandomState(11)
    initial = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    initial = jax.tree_util.tree_map(lambda x: np.asarray(rng.randn(*x.shape) * 0.2, np.float32), initial)
    return config, model, initial, jax.jit(jax.grad(jax_make_mlm_loss_fn(model)))


def _mlm_batch(rng: np.random.RandomState, vocab_size: int) -> dict:
    labels = rng.randint(0, vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    mlm_mask = rng.rand(BATCH, SEQ) < 0.15
    mlm_mask[:, 0] = True  # every row has a masked position
    input_ids = np.where(mlm_mask, vocab_size - 1, labels).astype(np.int32)
    return {"input_ids": input_ids, "labels": labels, "mlm_mask": mlm_mask}


def test_slice_averager_is_one_peer_with_a_jax_host_peer(pool):
    """A slice at (2, 2, 1) (dp replicas, a tensor-parallel leaf and a replicated one)
    contributes its replicas' mean and every rank adopts the round's result, bit for bit
    the two-peer replay on the lossless wire (m + ((m + h)/2 − m) for the slice, m the
    replicas' mean, h the host's value); only rank 0 built a DHT, and the slice
    advertises one host's bandwidth."""
    rng = np.random.RandomState(8)
    replicas = [[rng.randn(4, 6).astype(np.float32), rng.randn(5).astype(np.float32)] for _ in range(2)]
    host = [rng.randn(4, 6).astype(np.float32), rng.randn(5).astype(np.float32)]
    specs = [P(None, "tp"), P()]
    jax_dht = JaxDHT(start=True)
    done = {}
    try:
        averager = JaxAverager([t.copy() for t in host], jax_dht, prefix="sliceavg", target_group_size=2,
                               min_group_size=2, min_matchmaking_time=2.0, compression=JaxNoCompression(), start=True)
        thread = threading.Thread(target=lambda: done.setdefault("ok", averager.step(timeout=40) is not None))
        thread.start()
        readings = pool.run(ranks.slice_averager_round, (2, 2, 1), replicas, specs,
                            [str(m) for m in jax_dht.get_visible_maddrs()], "sliceavg")
        thread.join(60)
        with averager.get_tensors() as tensors:
            host_after = [np.array(t, copy=True) for t in tensors]
        averager.shutdown()
    finally:
        jax_dht.shutdown()
    assert done.get("ok") and all(r["ok"] for r in readings)
    assert [r["dht_built"] for r in readings] == [1, 0, 0, 0] and readings[0]["bandwidth"] == 1.0e8
    for k, spec in enumerate(specs):
        m = (replicas[0][k] + replicas[1][k]) / np.float32(2)
        mean = (m + host[k]) / np.float32(2)
        assert host_after[k].tobytes() == (host[k] + (mean - host[k])).tobytes()
        slice_value = m + (mean - m)
        for reading in readings:
            block = slice_value
            if spec == P(None, "tp"):
                t = reading["coordinate"]["tp"]
                block = slice_value[:, 3 * t:3 * (t + 1)]
            assert reading["tensors"][k].tobytes() == np.ascontiguousarray(block).tobytes()


def test_a_port_slice_and_a_jax_optimizer_train_one_albert_as_one_large_batch(pool, albert):
    """The slice (4 ranks: each takes its [dp, sp] block of a global batch of 4, ring
    attention over sp) and a JAX Optimizer peer reach epoch 3 through one swarm. Each
    one's parameters and LAMB statistics are within 1e-5 of each leaf's largest
    magnitude of the replay (one ``lamb_with_warmup`` step of optax a epoch on the mean
    JAX-model gradient of every batch either peer accumulated; the key bias, whose
    gradient is 0, held as in the port Optimizer's test); the 4 ranks' states are
    identical bit for bit; the tracker counted 2 peers; both count leaves read 3."""
    config, model, initial, jax_grad = albert
    jax_dht = JaxDHT(start=True)
    slice_batches = [_mlm_batch(np.random.RandomState(300 + i), config.vocab_size) for i in range(60)]
    common = dict(run_id="slice_albert", target_batch_size=TARGET, batch_size_per_step=BATCH, matchmaking_time=1.0,
                  averaging_timeout=30.0, target_group_size=2)
    accumulated, results, errors = [], {}, []

    def run_jax():
        try:
            opt = JaxOptimizer(dht=jax_dht, params=jax.tree_util.tree_map(jnp.asarray, initial),
                               optimizer=jax_lamb_with_warmup(*LAMB), grad_compression=JaxNoCompression(),
                               state_averaging_compression=JaxNoCompression(),
                               tracker_opts=dict(min_refresh_period=0.2, default_refresh_period=0.5), **common)
            local_rng = np.random.RandomState(100)
            for _ in range(80):
                if opt.local_epoch >= EPOCHS:
                    break
                batch = _mlm_batch(local_rng, config.vocab_size)
                accumulated.append((opt.local_epoch, batch))
                opt.step(jax_grad(opt.params, {k: jnp.asarray(v) for k, v in batch.items()}), batch_size=BATCH)
                time.sleep(0.2)
            results["jax"] = (opt.local_epoch, [t.copy() for t in opt.state_averager._host_state_tensors()],
                              opt.state_averager._get_opt_counts())
            opt.shutdown()
        except Exception:
            import traceback

            errors.append(traceback.format_exc())

    thread = threading.Thread(target=run_jax)
    try:
        thread.start()
        readings = pool.run(ranks.slice_optimizer_training, SHAPE, initial, slice_batches,
                            [str(m) for m in jax_dht.get_visible_maddrs()], common, EPOCHS, LAMB, timeout=150)
        thread.join(120)
    finally:
        jax_dht.shutdown()
    assert not errors, errors
    assert all(r["epoch"] == EPOCHS and r["counts"] == [EPOCHS, EPOCHS] for r in readings)
    assert results["jax"][0] == EPOCHS and results["jax"][2] == [EPOCHS, EPOCHS]
    assert readings[0]["peers"] == 2
    for reading in readings[1:]:
        assert reading["accumulated"] == readings[0]["accumulated"]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(reading["state"]["tensors"], readings[0]["state"]["tensors"]))

    optimizer = jax_lamb_with_warmup(*LAMB)
    params = jax.tree_util.tree_map(jnp.asarray, initial)
    state = optimizer.init(params)
    steps = []
    for epoch in range(EPOCHS):
        batches = [batch for e, batch in accumulated if e == epoch]
        batches += [slice_batches[i] for e, i in readings[0]["accumulated"] if e == epoch]
        assert batches, f"no batch accumulated in epoch {epoch}"
        grads = [jax_grad(params, {k: jnp.asarray(v) for k, v in batch.items()}) for batch in batches]
        mean = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x, np.float64) for x in g) / len(g), *grads)
        updates, state = optimizer.update(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), mean),
                                          state, params)
        steps.append(LR_AT[epoch] * float(np.linalg.norm(np.asarray(params["shared_layer"]["key"]["bias"]))))
        params = optax.apply_updates(params, updates)
    replay = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    replay += [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state) if np.ndim(leaf) >= 1]
    limits = [1e-5 * max(float(np.abs(expected).max()), 1e-30) for expected in replay]
    n = len(jax.tree_util.tree_leaves(initial))
    key_bias = [jax.tree_util.keystr(path) for path, _ in
                jax.tree_util.tree_flatten_with_path(initial)[0]].index("['shared_layer']['key']['bias']")
    limits[key_bias] = 2 * sum(steps)
    for kind in (1, 2):
        limits[kind * n + key_bias] = 1e-5 * max(float(np.abs(x).max()) for x in replay[kind * n:(kind + 1) * n])
    for name, view in (("jax", results["jax"][1]), ("slice", readings[0]["state"]["tensors"])):
        assert len(view) == len(replay)
        for index, (got, expected) in enumerate(zip(view, replay)):
            assert np.isfinite(got).all() and np.abs(got - expected).max() <= limits[index], (
                name, index, np.abs(got - expected).max(), limits[index])


def _jax_slice(initial, model, jax_grad, batch=None, checkpoint=None):
    """JAX's SliceOptimizer on four virtual devices: two solo epochs on ``batch``, or
    ``checkpoint`` loaded."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, initial), NamedSharding(mesh, PartitionSpec()))
    opt = JaxSliceOptimizer(mesh=mesh, params=params, optimizer=jax_lamb_with_warmup(*LAMB),
                            dht_factory=lambda: JaxDHT(start=True), run_id=f"jax_ckpt_{time.monotonic_ns()}",
                            target_batch_size=10**9, batch_size_per_step=BATCH)
    try:
        if checkpoint is None:
            for _ in range(2):
                opt.step(jax_grad(opt.params, {k: jnp.asarray(v) for k, v in batch.items()}), batch_size=BATCH)
                opt.force_epoch_transition()
        else:
            opt.load_state_dict(checkpoint)
        counts = [int(leaf) for leaf in jax.tree_util.tree_leaves(opt.opt_state) if np.ndim(leaf) == 0]
        return opt.state_dict(), counts
    finally:
        opt.shutdown()


@pytest.mark.parametrize("shape", [SHAPE, (1, 2, 2)], ids=["2x1x2", "1x2x2"])
def test_slice_checkpoints_cross_between_the_packages(pool, albert, shape):
    """A port slice (at dp 2 × sp 2, or tensor-parallel at tp 2 × sp 2, where each rank
    updates whole leaves and keeps its shards) and JAX's SliceOptimizer each train two
    solo epochs on one batch from one set of weights: their checkpoints hold the same
    leaves in the same order, within
    1e-5 of each leaf's largest magnitude (fp32 rounding of two frameworks' gradients
    through two LAMB steps; the key bias's statistics, rounding noise of a zero
    gradient, within 1e-5 of their kind's largest). Each package then loads the other's
    checkpoint: its state reads back the same bits, at epoch 2 with every count at 2. The
    slice's ranks hold the same state bit for bit."""
    config, model, initial, jax_grad = albert
    batch = _mlm_batch(np.random.RandomState(21), config.vocab_size)
    port = pool.run(ranks.slice_optimizer_checkpoint, shape, initial, batch, None, SEQ, LAMB)
    jax_state, jax_counts = _jax_slice(initial, model, jax_grad, batch=batch)
    port_state = port[0]["state"]
    assert all(a.tobytes() == b.tobytes() for r in port[1:] for a, b in zip(r["state"]["tensors"], port_state["tensors"]))
    assert port_state["epoch"] == jax_state["epoch"] == 2 and port[0]["counts"] == jax_counts == [2, 2]
    assert [t.shape for t in port_state["tensors"]] == [np.shape(t) for t in jax_state["tensors"]]
    n = len(jax.tree_util.tree_leaves(initial))
    key_bias = [jax.tree_util.keystr(path) for path, _ in
                jax.tree_util.tree_flatten_with_path(initial)[0]].index("['shared_layer']['key']['bias']")
    for index, (got, want) in enumerate(zip(port_state["tensors"], jax_state["tensors"])):
        want = np.asarray(want)
        if index % n == key_bias:
            if index < n:
                continue  # LAMB normalizes the zero gradient's noise: the parameter's step is noise
            kind = index // n
            scale = max(float(np.abs(np.asarray(t)).max()) for t in jax_state["tensors"][kind * n:(kind + 1) * n])
        else:
            scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 1e-5 * scale, index

    loaded = pool.run(ranks.slice_optimizer_checkpoint, shape, initial, batch,
                      {"epoch": jax_state["epoch"], "tensors": [np.asarray(t) for t in jax_state["tensors"]]}, SEQ, LAMB)
    for reading in loaded:
        assert reading["state"]["epoch"] == 2 and reading["counts"] == [2, 2]
        assert all(a.tobytes() == np.asarray(b).tobytes() for a, b in zip(reading["state"]["tensors"], jax_state["tensors"]))
    jax_loaded, counts = _jax_slice(initial, model, jax_grad, checkpoint=port_state)
    assert jax_loaded["epoch"] == 2 and counts == [2, 2]
    assert all(np.asarray(a).tobytes() == b.tobytes() for a, b in zip(jax_loaded["tensors"], port_state["tensors"]))


def test_a_delayed_slice_trains_with_a_jax_peer(pool, albert):
    """With ``delay_grad_averaging`` the slice launches each swarm round in the
    background and lands its update at a later step: it still reaches epoch 2 beside a
    JAX Optimizer peer, its 4 ranks stepping the same batches into the same state bit
    for bit, every value finite and the counts equal on all ranks."""
    config, model, initial, jax_grad = albert
    jax_dht = JaxDHT(start=True)
    slice_batches = [_mlm_batch(np.random.RandomState(500 + i), config.vocab_size) for i in range(60)]
    # no state rounds: the slice's would start an epoch after the peer's, and wait out its timeout
    common = dict(run_id="slice_dpu", target_batch_size=TARGET, batch_size_per_step=BATCH, matchmaking_time=1.0,
                  averaging_timeout=30.0, target_group_size=2, average_state_every=100)
    stop = threading.Event()

    def run_jax():
        opt = JaxOptimizer(dht=jax_dht, params=jax.tree_util.tree_map(jnp.asarray, initial),
                           optimizer=jax_lamb_with_warmup(*LAMB), grad_compression=JaxNoCompression(),
                           state_averaging_compression=JaxNoCompression(),
                           tracker_opts=dict(min_refresh_period=0.2, default_refresh_period=0.5), **common)
        local_rng = np.random.RandomState(101)
        while not stop.is_set():
            batch = _mlm_batch(local_rng, config.vocab_size)
            opt.step(jax_grad(opt.params, {k: jnp.asarray(v) for k, v in batch.items()}), batch_size=BATCH)
            time.sleep(0.2)
        opt.shutdown()

    thread = threading.Thread(target=run_jax)
    try:
        thread.start()
        readings = pool.run(ranks.slice_optimizer_training, SHAPE, initial, slice_batches,
                            [str(m) for m in jax_dht.get_visible_maddrs()], dict(common, delay_grad_averaging=True),
                            2, LAMB, timeout=150)
    finally:
        stop.set()
        thread.join(60)
        jax_dht.shutdown()
    assert all(r["epoch"] == 2 for r in readings)
    assert len({tuple(r["counts"]) for r in readings}) == 1 and readings[0]["counts"][0] >= 1
    for reading in readings:
        assert reading["accumulated"] == readings[0]["accumulated"]
        assert all(np.isfinite(t).all() and t.tobytes() == u.tobytes()
                   for t, u in zip(reading["state"]["tensors"], readings[0]["state"]["tensors"]))


def test_a_late_slice_downloads_the_swarm_state_onto_every_rank(pool, albert):
    """A JAX Optimizer peer holds a state at epoch 4; a fresh slice at (1, 2, 2) joins its
    run and calls ``load_state_from_peers()``: rank 0 downloads, every rank adopts. The
    slice's state view equals the donor's bit for bit on every rank, its epoch and counts
    read 4, and each rank's tensor-parallel query weight is its block of the donor's."""
    config, model, initial, _ = albert
    jax_dht = JaxDHT(start=True)
    try:
        donor = JaxOptimizer(dht=jax_dht, run_id="slice_join", params=jax.tree_util.tree_map(jnp.asarray, initial),
                             optimizer=jax_lamb_with_warmup(*LAMB), target_batch_size=10**9, batch_size_per_step=BATCH,
                             state_averaging_compression=JaxNoCompression())
        rng = np.random.RandomState(41)
        tensors = [rng.randn(*np.shape(t)).astype(np.float32) for t in donor.state_averager._host_state_tensors()]
        donor.load_state_dict({"epoch": 4, "tensors": tensors, "opt_counts": [4, 4]})
        readings = pool.run(ranks.slice_catch_up, (1, 2, 2), initial, [str(m) for m in jax_dht.get_visible_maddrs()],
                            "slice_join", SEQ, LAMB, timeout=90)
        donor.shutdown()
    finally:
        jax_dht.shutdown()
    paths = ["/".join(str(e.key) for e in path) for path, _ in jax.tree_util.tree_flatten_with_path(initial)[0]]
    query = tensors[paths.index("shared_layer/query/kernel")]
    for reading in readings:
        assert reading["ok"] and reading["epoch"] == 4 and reading["counts"] == [4, 4]
        assert all(a.tobytes() == b.tobytes() for a, b in zip(reading["state"]["tensors"], tensors))
        tp = reading["coordinate"]["tp"]
        block = query[:, tp * 32:(tp + 1) * 32]  # its half of the heads, in the flax [in, out] layout
        np.testing.assert_array_equal(reading["params"]["shared_layer.query.weight"], block.T)


def test_the_collaborative_slice_example_trains_on_cpu_ranks():
    """``examples/slice_collaborative_training.py`` spawns its two ranks (sp 2, gloo on the
    CPU), trains tiny ALBERT as a solo swarm and advances epochs with local gradients."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, OMP_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, "-m", "hivemind_tpu_torch.examples.slice_collaborative_training", "--nproc", "2", "--sp", "2",
         "--device", "cpu", "--tiny", "--steps", "10", "--target_batch_size", "16", "--batch_size", "4",
         "--seq_len", "32", "--matchmaking_time", "1", "--init_method", f"tcp://localhost:{ranks.free_port()}"],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert result.returncode == 0, (result.stdout + result.stderr)[-3000:]
    epochs = [int(line.rsplit("done: epoch", 1)[1].split()[0]) for line in (result.stdout + result.stderr).splitlines()
              if "done: epoch" in line]
    assert len(epochs) == 2 and min(epochs) >= 2, epochs


def test_broadcast_thinning_keeps_the_ranks_in_lockstep(pool):
    """With the next epoch far away, rank 0 lets steps skip the decision broadcast; every
    rank skips the same steps (no collective is left unmatched), and a forced
    transition then lands the same update on every rank."""
    readings = pool.run(ranks.slice_thinning, (4, 1, 1), 40, timeout=90)
    assert readings[0]["skipped"] > 0
    assert len({r["skipped"] for r in readings}) == 1 and all(r["epoch"] == 1 for r in readings)
    for reading in readings:
        # each dp rank's gradient is its share of the slice's: 1 + 2 + 3 + 4 = 10, one SGD step at 0.5
        np.testing.assert_allclose(reading["w"], np.full((8, 4), -5.0, np.float32), rtol=0, atol=1e-6)


def test_a_failure_of_the_network_process_raises_on_every_rank(pool):
    """Rank 0's tracker fails inside a step's decision phase: rank 0 raises its error,
    the other three raise together (the decision broadcast's error flag), none hangs."""
    readings = pool.run(ranks.slice_network_failure, (4, 1, 1), SEQ, timeout=60)
    assert readings[0]["raised"] == "OSError" and "injected" in readings[0]["message"]
    assert all(r["raised"] == "RuntimeError" and "network process failed" in r["message"] for r in readings[1:])
