"""Port and JAX optimizers in one swarm: a JAX ``Optimizer`` and a port ``Optimizer``
train one tiny ALBERT (fp32, LAMB with warmup, lossless wire) to epoch 3 through the
DHT, and both end with the parameters and statistics of a single-process large-batch
replay; a PowerSGD round between a JAX and a port averager matches the numpy replay of
the algorithm. Each swarm test runs under a wall-clock deadline."""

from __future__ import annotations

import contextlib
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from hivemind_tpu.compression import NoCompression as JaxNoCompression
from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.models import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models import AlbertForMaskedLM as JaxAlbertForMaskedLM
from hivemind_tpu.models import make_mlm_loss_fn as jax_make_mlm_loss_fn
from hivemind_tpu.moe.server.layers import lamb_with_warmup as jax_lamb_with_warmup
from hivemind_tpu.optim import Optimizer as JaxOptimizer
from hivemind_tpu.optim import PowerSGDGradientAverager as JaxPowerSGD
from hivemind_tpu_torch.compression import NoCompression
from hivemind_tpu_torch.convert import from_flax_albert_params
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM, make_mlm_loss_fn
from hivemind_tpu_torch.moe.server.layers import lamb_with_warmup
from hivemind_tpu_torch.optim import Optimizer, PowerSGDGradientAverager

BATCH, SEQ, TARGET, EPOCHS = 4, 16, 16, 3
LR, WARMUP, TOTAL = 1e-2, 1, 100
LR_AT = [0.0, LR, LR * (1 - 1 / (TOTAL - WARMUP))]  # lamb_with_warmup's rate at counts 0, 1, 2


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


def _mlm_batch(rng: np.random.RandomState, vocab_size: int) -> dict:
    labels = rng.randint(0, vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    mlm_mask = rng.rand(BATCH, SEQ) < 0.15
    mlm_mask[:, 0] = True  # every row has a masked position
    input_ids = np.where(mlm_mask, vocab_size - 1, labels).astype(np.int32)
    return {"input_ids": input_ids, "labels": labels, "mlm_mask": mlm_mask}


def test_a_jax_and_a_port_optimizer_train_one_albert_as_one_large_batch():
    """Both peers reach epoch 3. After it, each one's parameters and LAMB statistics
    (mu, nu) are within 1e-5 of each leaf's largest magnitude of a replay that applies,
    per epoch, one ``lamb_with_warmup`` step of optax to the sample-weighted mean
    gradient (computed by the JAX model) of every batch either peer accumulated: the
    gap is fp32 rounding of two frameworks' gradient sums carried through three
    updates (the key bias, whose exact gradient is 0, has its own limits below). The
    two peers agree with each other within the same limits, and both count leaves
    read 3."""
    jax_config = JaxAlbertConfig.tiny(dtype=jnp.float32, max_position=SEQ)
    jax_model = JaxAlbertForMaskedLM(jax_config)
    rng = np.random.RandomState(11)
    initial = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    initial = jax.tree_util.tree_map(lambda x: np.asarray(rng.randn(*x.shape) * 0.2, np.float32), initial)
    jax_grad = jax.jit(jax.grad(jax_make_mlm_loss_fn(jax_model)))

    jax_dht = JaxDHT(start=True)
    dht = DHT(initial_peers=[str(m) for m in jax_dht.get_visible_maddrs()], start=True)
    common = dict(run_id="mixed_albert", target_batch_size=TARGET, batch_size_per_step=BATCH, matchmaking_time=1.0,
                  averaging_timeout=30.0, target_group_size=2,
                  tracker_opts=dict(min_refresh_period=0.2, default_refresh_period=0.5))
    accumulated = {"jax": [], "port": []}  # (epoch, batch) of every step
    results, errors = {}, []

    def run_jax():
        opt = JaxOptimizer(dht=jax_dht, params=jax.tree_util.tree_map(jnp.asarray, initial),
                           optimizer=jax_lamb_with_warmup(LR, WARMUP, TOTAL), grad_compression=JaxNoCompression(),
                           state_averaging_compression=JaxNoCompression(), **common)
        local_rng = np.random.RandomState(100)
        for _ in range(80):
            if opt.local_epoch >= EPOCHS:
                break
            batch = _mlm_batch(local_rng, jax_config.vocab_size)
            accumulated["jax"].append((opt.local_epoch, batch))
            opt.step(jax_grad(opt.params, {k: jnp.asarray(v) for k, v in batch.items()}), batch_size=BATCH)
            time.sleep(0.2)
        leaves = opt.state_averager._host_state_tensors()
        results["jax"] = (opt.local_epoch, [t.copy() for t in leaves], opt.state_averager._get_opt_counts())
        opt.shutdown()

    def run_port():
        model = AlbertForMaskedLM(AlbertConfig.tiny(dtype=torch.float32, max_position=SEQ))
        model.load_state_dict(from_flax_albert_params(initial))
        loss_fn = make_mlm_loss_fn(model)
        opt = Optimizer(dht=dht, params=model.named_parameters(), optimizer=lamb_with_warmup(LR, WARMUP, TOTAL),
                        grad_compression=NoCompression(), state_averaging_compression=NoCompression(), **common)
        local_rng = np.random.RandomState(200)
        for _ in range(80):
            if opt.local_epoch >= EPOCHS:
                break
            batch = _mlm_batch(local_rng, jax_config.vocab_size)
            accumulated["port"].append((opt.local_epoch, batch))
            loss_fn({k: torch.from_numpy(v) for k, v in batch.items()}).backward()
            opt.step(batch_size=BATCH)
            opt.zero_grad()
            time.sleep(0.2)
        results["port"] = (opt.local_epoch, opt.state_averager._host_state_tensors(),
                           opt.state_averager._get_opt_counts())
        opt.shutdown()

    def guarded(fn):
        def body():
            try:
                fn()
            except Exception:
                import traceback

                errors.append(traceback.format_exc())
        return body

    with deadline(150):
        try:
            threads = [threading.Thread(target=guarded(fn)) for fn in (run_jax, run_port)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(120)
        finally:
            dht.shutdown()
            jax_dht.shutdown()
    assert not errors, errors
    assert results["jax"][0] == results["port"][0] == EPOCHS
    assert results["jax"][2] == results["port"][2] == [EPOCHS, EPOCHS]

    # the replay: one optax update per epoch on the mean gradient of that epoch's batches
    optimizer = jax_lamb_with_warmup(LR, WARMUP, TOTAL)
    params = jax.tree_util.tree_map(jnp.asarray, initial)
    state = optimizer.init(params)
    steps = []
    for epoch in range(EPOCHS):
        batches = [batch for peer in accumulated.values() for e, batch in peer if e == epoch]
        assert batches, f"no batch accumulated in epoch {epoch}"
        grads = [jax_grad(params, {k: jnp.asarray(v) for k, v in batch.items()}) for batch in batches]
        mean = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x, np.float64) * BATCH for x in g) / (BATCH * len(g)),
                                      *grads)
        updates, state = optimizer.update(jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), mean),
                                          state, params)
        steps.append(LR_AT[epoch] * float(np.linalg.norm(np.asarray(params["shared_layer"]["key"]["bias"]))))
        params = optax.apply_updates(params, updates)
    replay = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    replay += [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state) if np.ndim(leaf) >= 1]
    limits = [1e-5 * max(float(np.abs(expected).max()), 1e-30) for expected in replay]
    # the key bias's exact gradient is 0 (softmax ignores it): its mu and nu are rounding
    # noise, held to 1e-5 of the largest statistic of their kind; LAMB normalizes that
    # noise into a step of lr * ||bias|| at most, so its parameter is held to twice the
    # sum of those steps
    n = len(jax.tree_util.tree_leaves(initial))
    key_bias = [jax.tree_util.keystr(path) for path, _ in
                jax.tree_util.tree_flatten_with_path(initial)[0]].index("['shared_layer']['key']['bias']")
    limits[key_bias] = 2 * sum(steps)
    for kind in (1, 2):
        limits[kind * n + key_bias] = 1e-5 * max(float(np.abs(x).max()) for x in replay[kind * n:(kind + 1) * n])
    for name, (_, view, _) in results.items():
        assert len(view) == len(replay)
        for index, (got, expected) in enumerate(zip(view, replay)):
            assert np.isfinite(got).all() and np.abs(got - expected).max() <= limits[index], (
                name, index, np.abs(got - expected).max(), limits[index])
    for index, (a, b) in enumerate(zip(results["jax"][1], results["port"][1])):
        assert np.abs(a - b).max() <= limits[index], index


def _powersgd_replay(grads: dict, weights: dict, rank: int):
    """The PowerSGD round in numpy, as the JAX package computes it: phase P averages
    M·Q of the seeded warm start, the mean is orthogonalized, phase Q averages Mᵀ·P and
    the raw tensors; returns the reconstruction and the raw mean."""
    from hivemind_tpu.utils.math_utils import orthogonalize

    total = sum(weights.values())
    mean = lambda xs: sum(x * (weights[i] / total) for i, x in xs.items())
    q0 = np.asarray(np.random.RandomState(0xC0FFEE).randn(32, rank), np.float32)
    p = orthogonalize(mean({i: g[0] @ q0 for i, g in grads.items()}).astype(np.float32))
    q = mean({i: g[0].T @ p for i, g in grads.items()})
    return p @ q.T, mean({i: g[1] for i, g in grads.items()})


def test_powersgd_round_of_a_jax_and_a_port_averager_matches_the_replay():
    """One JAX and one port ``PowerSGDGradientAverager`` (rank 4, weights 3 and 1):
    the rank-4 reconstruction of the [64, 32] gradient and the raw [8] mean on each
    peer are within 1e-5 of the largest magnitude of the replay (fp32 rounding of the
    weighted sums), and the two peers' results and error feedback agree within 1e-6."""
    shapes = [(64, 32), (8,)]
    grads, weights = {}, {0: 3, 1: 1}
    for i in weights:
        rng = np.random.RandomState(i)
        grads[i] = [(rng.randn(64, 6) @ rng.randn(6, 32)).astype(np.float32), rng.randn(8).astype(np.float32)]
    jax_dht = JaxDHT(start=True)
    dht = DHT(initial_peers=[str(m) for m in jax_dht.get_visible_maddrs()], start=True)
    averagers = []
    try:
        with deadline(90):
            common = dict(averager_rank=4, prefix="psgd_mixed", start=True, target_group_size=2,
                          min_matchmaking_time=1.0, request_timeout=1.0)
            averagers = [JaxPowerSGD([np.zeros(s, np.float32) for s in shapes], dht=jax_dht, **common),
                         PowerSGDGradientAverager([np.zeros(s, np.float32) for s in shapes], dht=dht, **common)]
            assert averagers[0].schema_hash == averagers[1].schema_hash
            for i, averager in enumerate(averagers):
                averager.accumulate_grads_(grads[i] if i == 0 else [torch.from_numpy(g) for g in grads[i]],
                                           batch_size=weights[i])
            controls = [averager.step(wait=False, timeout=40) for averager in averagers]
            for control in controls:
                control.result(timeout=60)
            loaded = {i: [(g * weights[i]) / weights[i] for g in grads[i]] for i in weights}
            approx, raw = _powersgd_replay(loaded, weights, rank=4)
            outputs = []
            for averager in averagers:
                with averager.use_averaged_gradients() as out:
                    out = [np.array(t) for t in out]
                outputs.append(out)
                assert np.abs(out[0] - approx).max() <= 1e-5 * np.abs(approx).max()
                assert np.abs(out[1] - raw).max() <= 1e-5 * np.abs(raw).max()
            assert np.abs(outputs[0][0] - outputs[1][0]).max() <= 1e-6 * np.abs(approx).max()
            for i, averager in enumerate(averagers):
                residual = loaded[i][0] - outputs[i][0]
                assert np.abs(averager._error_feedback[0] - residual).max() <= 1e-6 * np.abs(loaded[i][0]).max()
    finally:
        for averager in averagers:
            averager.shutdown()
        dht.shutdown()
        jax_dht.shutdown()


def test_an_fp16_state_wire_turns_small_second_moments_negative_in_both_packages():
    """A fault of the reference that the port keeps for parity: averaged over the fp16
    wire in a group of four (two JAX and two port averagers), small non-negative values
    (Adam's second moments of tiny gradients) come back negative in about one element in
    ten on every peer of either package: a peer adds the fp16-rounded difference to the
    mean, and rounding to fp16's subnormal spacing (6e-8) overshoots a value smaller than
    it. A LAMB update from such a state is NaN in optax and in the port's transforms
    alike. A lossless state wire keeps every value non-negative."""
    from hivemind_tpu.averaging import DecentralizedAverager as JaxAverager
    from hivemind_tpu.compression import Float16Compression as JaxFloat16
    from hivemind_tpu_torch.averaging import DecentralizedAverager
    from hivemind_tpu_torch.compression import Float16Compression
    from hivemind_tpu_torch.optim import transforms as T

    rng = np.random.RandomState(0)
    values = [np.abs(rng.randn(4096)).astype(np.float32) * 3e-8 for _ in range(4)]
    negative = {}
    for compression in ("fp16", "none"):
        jax_dhts = [JaxDHT(start=True)]
        jax_dhts.append(JaxDHT(initial_peers=[str(m) for m in jax_dhts[0].get_visible_maddrs()], start=True))
        dhts = [DHT(initial_peers=[str(m) for m in jax_dhts[0].get_visible_maddrs()], start=True) for _ in range(2)]
        common = dict(prefix=f"moments_{compression}", start=True, target_group_size=4, min_group_size=4,
                      min_matchmaking_time=1.0)
        averagers = [JaxAverager([values[i]], jax_dhts[i], **common,
                                 compression=JaxFloat16() if compression == "fp16" else JaxNoCompression())
                     for i in range(2)]
        averagers += [DecentralizedAverager([values[2 + i]], dhts[i], **common,
                                            compression=Float16Compression() if compression == "fp16" else NoCompression())
                      for i in range(2)]
        try:
            with deadline(60):
                for control in [averager.step(wait=False, timeout=30) for averager in averagers]:
                    control.result(timeout=40)
                results = []
                for averager in averagers:
                    with averager.get_tensors() as tensors:
                        results.append(np.array(tensors[0]))
        finally:
            for averager in averagers:
                averager.shutdown()
            for dht in dhts + jax_dhts:
                dht.shutdown()
        negative[compression] = [float((result < 0).mean()) for result in results]
    assert all(share > 0.05 for share in negative["fp16"]), negative
    assert all(share == 0.0 for share in negative["none"]), negative

    # a LAMB step from such second moments: NaN on both sides where they are negative
    nu = np.asarray([-3e-8, 1e-9, -1e-8, 2e-8], np.float32)
    grads, params = np.full(4, 1e-4, np.float32), np.ones(4, np.float32)
    lamb = optax.lamb(1e-3)
    state = lamb.init({"w": jnp.asarray(params)})
    state = (state[0]._replace(nu={"w": jnp.asarray(nu)}), *state[1:])
    updates, _ = lamb.update({"w": jnp.asarray(grads)}, state, {"w": jnp.asarray(params)})
    port = T.lamb(1e-3)
    port_state = port.init({"w": torch.from_numpy(params)})
    port_state = (port_state[0]._replace(nu={"w": torch.from_numpy(nu)}), *port_state[1:])
    port_updates, _ = port.update({"w": torch.from_numpy(grads)}, port_state, {"w": torch.from_numpy(params)})
    assert np.isnan(np.asarray(updates["w"])).all() and torch.isnan(port_updates["w"]).all()
