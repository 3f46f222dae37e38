"""The port's collaborative ``Optimizer`` in its other modes, on port-only swarms over
loopback: a client-mode peer, an auxiliary peer that learns the gradient schema from
the swarm, local updates with delayed state averaging (and the deferred delta-rule
landing), delayed parameter updates (DPU) that never write the parameters under a
running batch, catch-up after missed epochs, the NaN guard's restore, and the chronic
failure counter. Each swarm test runs under a wall-clock deadline."""

from __future__ import annotations

import contextlib
import signal
import threading
import time

import numpy as np
import pytest
import torch

from hivemind_tpu_torch.compression import NoCompression
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.optim import NaNGuard, Optimizer, TrainingStateAverager
from hivemind_tpu_torch.optim import transforms as T
from hivemind_tpu_torch.telemetry import REGISTRY
from hivemind_tpu_torch.telemetry.tracing import add_span_listener, remove_span_listener

FEATURES = 8
TRACKER = dict(min_refresh_period=0.2, default_refresh_period=0.5)


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


def _swarm(n: int):
    first = DHT(start=True)
    maddrs = [str(m) for m in first.get_visible_maddrs()]
    return [first] + [DHT(initial_peers=maddrs, start=True) for _ in range(n - 1)]


class LeastSquares(torch.nn.Module):
    """Linear regression through a [4, 8] linear map (a transposed kernel leaf in the
    averaged view), its bias and a head offset, every peer starting from the same values."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(FEATURES, 4, bias=True)
        self.head = torch.nn.Parameter(torch.full((4,), 0.5))
        torch.nn.init.zeros_(self.proj.weight)
        torch.nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        return self.proj(x).sum(-1) + self.head.sum()


_RNG = np.random.RandomState(0)
_TRUE_W = _RNG.randn(FEATURES).astype(np.float32)
_X = _RNG.randn(256, FEATURES).astype(np.float32)
_Y = _X @ _TRUE_W


def _loss(model, rng):
    index = rng.choice(len(_X), 16)
    x, y = torch.from_numpy(_X[index]), torch.from_numpy(_Y[index])
    return torch.mean((model(x) - y) ** 2)


def _run_peers(dhts, make_opt, epochs: int, steps: int = 80, pause: float = 0.2, limit: float = 90,
               landed: bool = False):
    """Each peer trains in its own thread until ``epochs``; returns per peer (the mean
    loss of its first two batches, of its last three, its epoch, its parameters).
    ``landed``: read the last three losses (on three more batches) and the parameters
    once the optimizer's shutdown has finished and landed the epoch's update, which a
    delayed-update (DPU) peer still has in flight when it reaches ``epochs``."""
    results, errors = {}, []

    def run(index, dht):
        try:
            torch.manual_seed(0)
            model = LeastSquares()
            opt = make_opt(index, dht, model)
            rng = np.random.RandomState(index + 1)
            losses = []
            for _ in range(steps):
                if opt.local_epoch >= epochs:
                    break
                loss = _loss(model, rng)
                loss.backward()
                losses.append(loss.item())
                opt.step(batch_size=16)
                opt.zero_grad()
                time.sleep(pause)
            epoch = opt.local_epoch
            if landed:
                opt.shutdown()
                with torch.no_grad():
                    losses += [_loss(model, rng).item() for _ in range(3)]
            results[index] = (float(np.mean(losses[:2])), float(np.mean(losses[-3:])), epoch,
                              {k: v.detach().clone() for k, v in opt.params.items()})
            if not landed:
                opt.shutdown()
        except Exception:
            import traceback

            errors.append((index, traceback.format_exc()))

    with deadline(limit + 30):
        threads = [threading.Thread(target=run, args=(i, d)) for i, d in enumerate(dhts)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(limit)
    assert not errors, errors
    return results


def _assert_trained_together(results, epochs: int, atol: float, factor: float = 5.0):
    assert len(results) == 2
    for index, (first, last, epoch, _) in results.items():
        assert epoch >= epochs and last < first / factor, (index, first, last, epoch)
    a, b = results[0][3], results[1][3]
    assert all(torch.allclose(a[k], b[k], atol=atol) for k in a), "the peers diverged"


def test_client_mode_peer_trains_with_a_full_peer():
    """A client-mode peer (sends gradients, never reduces) and a full peer reach epoch
    3 together, converge (loss / 5) and hold parameters within 1e-5 of each other (a
    lossless wire)."""
    dhts = _swarm(2)
    try:
        make = lambda i, dht, model: Optimizer(
            dht=dht, run_id="client_mode", target_batch_size=64, params=model.named_parameters(),
            optimizer=T.sgd(0.1), batch_size_per_step=16, matchmaking_time=1.0, averaging_timeout=20,
            target_group_size=2, client_mode=i == 1, grad_compression=NoCompression(),
            state_averaging_compression=NoCompression(), tracker_opts=TRACKER)
        _assert_trained_together(_run_peers(dhts, make, epochs=3), 3, atol=1e-5)
    finally:
        for dht in dhts:
            dht.shutdown()


def test_auxiliary_peer_learns_the_gradient_schema_from_the_swarm():
    """An auxiliary peer with no model knowledge downloads the gradient schema (the
    parameters in the JAX package's layout: ``proj.weight`` [4, 8] as a [8, 4] kernel)
    and gets the worker's schema hash; it then assists a round at weight 0."""
    dhts = _swarm(2)
    worker = aux = None
    try:
        with deadline(60):
            model = LeastSquares()
            worker = Optimizer(dht=dhts[0], run_id="aux_boot", target_batch_size=64, params=model.named_parameters(),
                               optimizer=T.sgd(0.1), batch_size_per_step=16, matchmaking_time=1.0)
            aux = Optimizer(dht=dhts[1], run_id="aux_boot", target_batch_size=64, auxiliary=True,
                            matchmaking_time=1.0, load_state_timeout=30)
            with aux.grad_averager.get_tensors() as tensors:
                shapes = [tuple(t.shape) for t in tensors]
            assert shapes == [(4,), (4,), (FEATURES, 4)]  # head, proj.bias, proj.kernel
            assert aux.grad_averager.schema_hash == worker.grad_averager.schema_hash
            assert aux.step() is None and aux.state_averager is None
    finally:
        for opt in (aux, worker):
            if opt is not None:
                opt.shutdown()
        for dht in dhts:
            dht.shutdown()


def test_local_updates_with_delayed_state_averaging():
    """use_local_updates + delay_state_averaging + delta_rule_averaging: state rounds
    run on the background thread and land at the next step; two peers converge and
    stay within 0.25 of each other (local SGD between rounds)."""
    dhts = _swarm(2)
    try:
        make = lambda i, dht, model: Optimizer(
            dht=dht, run_id="local_sgd", target_batch_size=64, params=model.named_parameters(),
            optimizer=T.sgd(0.05), batch_size_per_step=16, matchmaking_time=1.0, averaging_timeout=20,
            target_group_size=2, use_local_updates=True, delay_state_averaging=True, delta_rule_averaging=True,
            tracker_opts=TRACKER)
        _assert_trained_together(_run_peers(dhts, make, epochs=3), 3, atol=0.25)
    finally:
        for dht in dhts:
            dht.shutdown()


@pytest.mark.parametrize("defer", [False, True], ids=["immediate", "deferred"])
def test_delta_rule_keeps_a_step_taken_during_the_round(defer):
    """A local step (w 10 -> 6, SGD lr 1, gradient 4) lands while the round is in
    flight and the group averages to 8: the delta rule gives 6 + (8 - 10) = 4. A
    deferred round leaves the live parameters alone until ``land_pending()``. The
    round's ``state_averager.round`` span says it averaged."""
    dht = DHT(start=True)
    try:
        w = torch.nn.Parameter(torch.full((4,), 10.0))
        averager = TrainingStateAverager(dht=dht, optimizer=T.sgd(1.0), params={"w": w}, prefix="delta_rule",
                                         start=True, delta_rule_averaging=True, average_opt_statistics=False)

        def fake_step(timeout=None, wait=True, **kwargs):
            averager.apply_optimizer_step({"w": torch.full((4,), 4.0)})
            with averager.get_tensors() as tensors:
                tensors[0].fill_(8.0)
            return {}

        averager.step = fake_step
        rounds = []  # the round's span carries its outcome

        def on_span(span):
            if span.name == "state_averager.round" and span.attributes["peer"] == str(averager.peer_id):
                rounds.append(span.attributes["averaged"])

        add_span_listener(on_span)
        try:
            assert averager.do_averaging_round(timeout=5, defer=defer)
        finally:
            remove_span_listener(on_span)
        assert rounds == [True]
        if defer:
            assert torch.equal(w.detach(), torch.full((4,), 6.0))
            averager.land_pending()
        assert torch.equal(w.detach(), torch.full((4,), 4.0))
        averager.shutdown()
    finally:
        dht.shutdown()


def test_delayed_update_never_writes_parameters_under_a_running_step():
    """DPU: while the background transition is in flight (held at its end), the
    caller's next step computes on the old parameters, byte for byte; the update lands
    at the first step after the transition finished."""
    dht = DHT(start=True)
    opt = None
    try:
        with deadline(60):
            model = LeastSquares()
            opt = Optimizer(dht=dht, run_id="dpu_hazard", target_batch_size=16, params=model.named_parameters(),
                            optimizer=T.sgd(0.1), batch_size_per_step=16, delay_optimizer_step=True,
                            tracker_opts=TRACKER)
            release = threading.Event()
            finish = opt._finish_epoch_transition

            def held(*args, **kwargs):
                release.wait(30)
                return finish(*args, **kwargs)

            opt._finish_epoch_transition = held
            before = {k: v.detach().clone() for k, v in opt.params.items()}
            rng = np.random.RandomState(3)
            while opt._pending_update is None:
                _loss(model, rng).backward()
                opt.step(batch_size=16)
                opt.zero_grad()
                time.sleep(0.05)
            while opt.state_averager._staged is None:
                time.sleep(0.01)
            staged = {k: v.clone() for k, v in opt.state_averager._staged.items()}
            assert any(not torch.equal(staged[k], before[k]) for k in before)
            loss = _loss(model, rng)  # a batch during the update: the old parameters
            loss.backward()
            opt.step(batch_size=16)
            assert all(torch.equal(v.detach(), before[k]) for k, v in opt.params.items())
            opt.zero_grad()
            release.set()
            opt._pending_update.result(30)
            assert opt.local_epoch == 1
            assert all(torch.equal(v.detach(), before[k]) for k, v in opt.params.items())
            opt.step()  # no gradients: lands the finished update
            assert all(torch.equal(v.detach(), staged[k]) for k, v in opt.params.items())
    finally:
        if opt is not None:
            opt.shutdown()
        dht.shutdown()


def test_delayed_updates_train_two_peers():
    """Two DPU peers (the update runs in the background) reach epoch 3, halve their
    loss (gradients one epoch stale: a smaller rate than the synchronous tests', which
    would oscillate with the delay) and agree within 1e-4 (lossless wire), both read
    once the last epoch's update has landed: the losses of the last training steps
    lag the updates by as many steps as each background update takes to land, so under
    the whole suite's load they had fallen by a factor of only 1.7 and 2.0 (2.5-6.5
    alone beside busy loops; 5.4-11.0 once landed). A round whose all-reduce fails (a
    peer answering PROTOCOL_VIOLATION: 3 of 8 runs on an idle host) waits out its 20-30
    s in the background while the peers keep stepping, 0.2 s a step; the budget of 480
    steps and 150 s holds three such rounds (160 steps did not hold two)."""
    dhts = _swarm(2)
    try:
        make = lambda i, dht, model: Optimizer(
            dht=dht, run_id="dpu_pair", target_batch_size=64, params=model.named_parameters(),
            optimizer=T.sgd(0.05), batch_size_per_step=16, matchmaking_time=1.0, averaging_timeout=20,
            target_group_size=2, delay_optimizer_step=True, grad_compression=NoCompression(),
            state_averaging_compression=NoCompression(), tracker_opts=TRACKER)
        _assert_trained_together(_run_peers(dhts, make, epochs=3, steps=480, limit=150, landed=True), 3, atol=1e-4,
                                 factor=2.0)
    finally:
        for dht in dhts:
            dht.shutdown()


def test_a_peer_two_epochs_behind_downloads_the_swarms_state():
    """Peer B at epoch 0 sees the swarm at epoch 3: its next step downloads A's state
    (parameters and statistics byte for byte over a lossless state wire), adopts epoch
    3 and fast-forwards its count leaves to 3."""
    dhts = _swarm(2)
    opts = []
    try:
        with deadline(60):
            models = [LeastSquares(), LeastSquares()]
            opts = [Optimizer(dht=dht, run_id="catch_up", target_batch_size=10**6, params=model.named_parameters(),
                              optimizer=T.adam(1e-2), batch_size_per_step=16, load_state_timeout=20,
                              state_averaging_compression=NoCompression(), tracker_opts=TRACKER)
                    for dht, model in zip(dhts, models)]
            leader, straggler = opts
            with torch.no_grad():
                for i, param in enumerate(models[0].parameters()):
                    param.copy_(torch.arange(param.numel(), dtype=torch.float32).view_as(param) + i)
            leader.state_averager.apply_optimizer_step({k: torch.ones_like(v) for k, v in leader.params.items()})
            leader.state_averager.local_epoch = 3
            leader.state_averager.state_sharing_priority = 3
            leader.tracker.update_epoch(3)
            while straggler.tracker.global_epoch < 3:
                time.sleep(0.1)
            assert straggler._should_load_state_from_peers()
            straggler.step()
            assert straggler.local_epoch == 3 and straggler.state_averager._get_opt_counts() == [3]
            download = straggler.state_averager.last_download  # what the catch-up adopted
            assert download.verified and download.donors[-1] == dhts[0].peer_id.to_base58()
            for mine, theirs in zip(straggler.state_averager._host_state_tensors(),
                                    leader.state_averager._host_state_tensors()):
                assert mine.tobytes() == theirs.tobytes()
    finally:
        for opt in opts:
            opt.shutdown()
        for dht in dhts:
            dht.shutdown()


def test_nan_guard_restores_the_last_backup():
    """A solo peer trains a few epochs through the guard; a NaN loss restores the last
    backup (parameters, statistics, epoch) and drops the step; with ``check_grads`` a
    finite loss over a non-finite gradient is caught too."""
    dht = DHT(start=True)
    opt = None
    try:
        with deadline(60):
            model = LeastSquares()
            opt = Optimizer(dht=dht, run_id="nan_guard", target_batch_size=16, params=model.named_parameters(),
                            optimizer=T.adam(1e-2), batch_size_per_step=16, tracker_opts=TRACKER)
            guard = NaNGuard(opt, backup_every=2, check_grads=True)
            rng = np.random.RandomState(5)
            while opt.local_epoch < 3:
                loss = _loss(model, rng)
                loss.backward()
                guard.step(loss)
                opt.zero_grad()
                time.sleep(0.05)
            backup = guard._backup
            assert backup is not None
            guard.step(float("nan"))
            assert guard.restores == 1 and opt.local_epoch == backup["epoch"]
            for got, expected in zip(opt.state_averager._host_state_tensors(), backup["tensors"]):
                assert got.tobytes() == np.asarray(expected).tobytes()
            model.head.grad = torch.tensor([float("inf"), 0.0, 0.0, 0.0])
            guard.step(1.0)
            assert guard.restores == 2 and guard.skipped_steps == 2
    finally:
        if opt is not None:
            opt.shutdown()
        dht.shutdown()


def test_chronic_counter_counts_epochs_that_fall_back_to_local_gradients():
    """A peer whose partner never joins a round: each epoch falls back to local
    gradients, the counter and its gauge climb, and past the threshold the peer is
    flagged chronic and backs off matchmaking."""
    dhts = _swarm(2)
    opts = []
    try:
        with deadline(90):
            models = [LeastSquares(), LeastSquares()]
            opts = [Optimizer(dht=dht, run_id="chronic", target_batch_size=32, params=model.named_parameters(),
                              optimizer=T.sgd(0.05), batch_size_per_step=16, matchmaking_time=0.5,
                              averaging_timeout=2.0, average_state_every=0, chronic_failure_threshold=2,
                              target_group_size=2, tracker_opts=TRACKER)
                    for dht, model in zip(dhts, models)]
            active = opts[0]
            while active.tracker.global_progress.num_peers < 2:
                time.sleep(0.1)
            rng = np.random.RandomState(7)
            while active.local_epoch < 2:
                _loss(models[0], rng).backward()
                active.step(batch_size=16)
                active.zero_grad()
            gauge = REGISTRY.get("hivemind_optim_consecutive_failed_rounds").labels().value
            assert active.consecutive_failed_averaging_rounds == 2 == gauge
            assert active.chronic_averaging_failure
            assert active._matchmaking_delay() == min(0.5 * 2, 1.0)
    finally:
        for opt in opts:
            opt.shutdown()
        for dht in dhts:
            dht.shutdown()


def test_checkpoints_restore_a_restarted_peer(tmp_path):
    """A solo peer with ``checkpoint_dir`` trains to epoch 2 and shuts down (a forced
    save); a new Optimizer on the same directory restores its epoch, count leaves and
    every tensor's bytes before it joins anything, and ``state_dict`` round-trips."""
    dht = DHT(start=True)
    opts = []
    try:
        with deadline(60):
            model = LeastSquares()
            make = lambda model: Optimizer(dht=dht, run_id="ckpt", target_batch_size=16,
                                           params=model.named_parameters(), optimizer=T.adam(1e-2),
                                           batch_size_per_step=16, checkpoint_dir=tmp_path, tracker_opts=TRACKER)
            first = make(model)
            opts.append(first)
            rng = np.random.RandomState(9)
            while first.local_epoch < 2:
                _loss(model, rng).backward()
                first.step(batch_size=16)
                first.zero_grad()
                time.sleep(0.05)
            first.shutdown()
            saved = first.state_dict()
            restarted = make(LeastSquares())
            opts.append(restarted)
            assert restarted.local_epoch == saved["epoch"] >= 2
            assert restarted.state_averager._get_opt_counts() == saved["opt_counts"]
            for got, expected in zip(restarted.state_dict()["tensors"], saved["tensors"]):
                assert got.tobytes() == expected.tobytes()
            restarted.load_state_dict(dict(saved, epoch=7))
            assert restarted.local_epoch == 7
    finally:
        for opt in opts[1:]:
            opt.shutdown()
        dht.shutdown()


@pytest.mark.parametrize("form", ["grad", "mapping", "list"])
def test_step_takes_each_parameters_grad_or_explicit_gradients_alike(form):
    """``step()`` reading ``.grad``, ``step(mapping)`` and ``step(list)`` in the
    parameters' order accumulate the same host gradients, in the averaged view's layout
    (the [4, 8] weight as an [8, 4] kernel), scaled by the batch size."""
    dht = DHT(start=True)
    opt = None
    try:
        model = LeastSquares()
        opt = Optimizer(dht=dht, run_id=f"grad_forms_{form}", target_batch_size=10**6,
                        params=model.named_parameters(), optimizer=T.sgd(0.1), batch_size_per_step=16)
        _loss(model, np.random.RandomState(11)).backward()
        grads = {name: p.grad.clone() for name, p in model.named_parameters()}
        if form == "grad":
            opt.step(batch_size=16)
        else:
            opt.zero_grad()
            opt.step(grads if form == "mapping" else list(grads.values()), batch_size=16)
        accumulators = opt.grad_averager._grad_accumulators
        expected = [grads["head"], grads["proj.bias"], grads["proj.weight"].T]  # the flax tree's order
        assert all(np.array_equal(acc, (g.numpy() * 16).astype(np.float32)) for acc, g in zip(accumulators, expected))
        assert opt.grad_averager.local_samples_accumulated == 16
    finally:
        if opt is not None:
            opt.shutdown()
        dht.shutdown()
