"""The port's mixture-of-experts client against the JAX package's, on one mixed swarm:
a port server and a JAX server each serve half of a (4, 4) expert grid (two cells
stay empty), found through the DHT by both packages' clients. Both beam searchers
choose the same experts (and the exhaustive top-k); dead prefixes are negatively
cached; ``RemoteCallMany`` masks a dead expert, raises under ``k_min``, abandons a
straggler into its breaker and counts a shed once; the port's mixtures (plain and
switch) give the JAX mixtures' outputs, input and gate gradients and switch
utilization; and each package's ``SwarmMonitor`` reads the other's snapshots.

Tolerances: the experts are fp32 (Dense in float32, then tanh), never trained
(learning rate 0), behind the "none" wire, so both mixtures compute the same fp32
arithmetic: 1e-5. Each test runs under a wall-clock deadline."""

from __future__ import annotations

import contextlib
import signal
import time

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.moe.client.beam_search import MoEBeamSearcher as JaxMoEBeamSearcher
from hivemind_tpu.moe.client.moe import RemoteMixtureOfExperts as JaxRemoteMixtureOfExperts
from hivemind_tpu.moe.client.moe import RemoteSwitchMixtureOfExperts as JaxRemoteSwitchMixtureOfExperts
from hivemind_tpu.moe.server.dht_handler import get_experts as jax_get_experts
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.moe.server.server import Server as JaxServer
from hivemind_tpu.telemetry.monitor import SwarmMonitor as JaxSwarmMonitor
from hivemind_tpu.telemetry.monitor import TelemetryPublisher as JaxTelemetryPublisher
from hivemind_tpu.telemetry.monitor import fetch_swarm_telemetry as jax_fetch_swarm_telemetry
from hivemind_tpu_torch.convert import from_flax_albert_params
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe import (
    MoEBeamSearcher,
    RemoteCallMany,
    RemoteExpert,
    RemoteMixtureOfExperts,
    RemoteSwitchMixtureOfExperts,
    Server,
    get_experts,
)
from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
from hivemind_tpu_torch.moe.server import ModuleBackend
from hivemind_tpu_torch.moe.server.layers.common import Dense
from hivemind_tpu_torch.resilience import CHAOS, reset_all_boards
from hivemind_tpu_torch.telemetry.monitor import SwarmMonitor, TelemetryPublisher, fetch_swarm_telemetry

HID = 16
GRID = (4, 4)
PREFIX = "mx."
MISSING = {(3, 0), (3, 1), (3, 2), (3, 3), (1, 2)}  # row 3 is a dead prefix
TOL = 1e-5


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


@pytest.fixture(autouse=True)
def reset_port_breakers():
    yield
    reset_all_boards()
    CHAOS.clear()


def failures(uid: str) -> int:
    """Consecutive failures on ``uid``'s breaker (0 for a breaker never created)."""
    breaker = EXPERT_BREAKERS._get(uid, False)
    return 0 if breaker is None else breaker._consecutive_failures


def wait_for(predicate, timeout: float = 20.0, what: str = "condition"):
    started = time.monotonic()
    while not predicate():
        if time.monotonic() - started > timeout:
            raise TimeoutError(f"{what} not reached in {timeout} s")
        time.sleep(0.05)


class JaxLinearTanh(jnn.Module):
    hid: int

    @jnn.compact
    def __call__(self, x):
        return jnp.tanh(jnn.Dense(self.hid, dtype=jnp.float32, param_dtype=jnp.float32)(x))


class LinearTanh(nn.Module):
    def __init__(self, hid: int):
        super().__init__()
        self.Dense_0 = Dense(hid, hid, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.Dense_0(x))


def expert_pair(uid: str, seed: int):
    """An fp32 expert in each package with the same weights, never trained."""
    sample = np.zeros((2, HID), np.float32)
    theirs = JaxModuleBackend(uid, JaxLinearTanh(HID), optimizer=optax.sgd(0.0), sample_input=sample, rng_seed=seed)
    params = from_flax_albert_params(jax.tree_util.tree_map(np.asarray, theirs.params))
    return theirs, ModuleBackend(uid, LinearTanh(HID), sample_input=sample, params=params, device="cpu")


class MixedGrid:
    """Cells (i, j) with i + j even on the port server, the others on the JAX server;
    the MISSING cells nowhere. ``twins`` holds a port backend of every expert."""

    def __init__(self):
        port, jax_side, self.twins = {}, {}, {}
        for i in range(GRID[0]):
            for j in range(GRID[1]):
                if (i, j) in MISSING:
                    continue
                uid = f"{PREFIX}{i}.{j}"
                theirs, ours = expert_pair(uid, seed=10 * i + j)
                self.twins[uid] = ours
                if (i + j) % 2 == 0:
                    port[uid] = ours
                else:
                    jax_side[uid] = theirs
        # every peer joins before any server declares, so each declaration (and its
        # prefix records) reaches every peer: the beam search reads the first fresh
        # record it finds, which a late joiner might hold only in part
        self.dht = DHT(start=True)
        maddrs = [str(m) for m in self.dht.get_visible_maddrs()]
        self.jax_dht = JaxDHT(initial_peers=maddrs, start=True)
        self.client_dht = DHT(initial_peers=maddrs, start=True)
        self.jax_client_dht = JaxDHT(initial_peers=maddrs, start=True)
        self.server = Server(self.dht, port, activation_compression="none")
        self.server.run_in_background(await_ready=True, timeout=30)
        self.jax_server = JaxServer(self.jax_dht, jax_side, activation_compression="none")
        self.jax_server.run_in_background(await_ready=True, timeout=30)
        self.uids = sorted(self.twins)
        wait_for(lambda: all(info is not None for info in get_experts(self.client_dht, self.uids))
                 and all(info is not None for info in jax_get_experts(self.jax_client_dht, self.uids)),
                 what="both packages' clients resolving every expert")
        # the two servers declare the prefix records' subkeys in the background: wait
        # until both clients read each grid row's full set of coordinates
        rows = {PREFIX.rstrip("."): {i for i in range(GRID[0]) if any((i, j) not in MISSING for j in range(GRID[1]))}}
        rows.update({f"{PREFIX}{i}": {j for j in range(GRID[1]) if (i, j) not in MISSING} for i in rows[PREFIX[:-1]]})
        wait_for(lambda: all(self._coords(dht, prefix) == coords for dht in (self.client_dht, self.jax_client_dht)
                             for prefix, coords in rows.items()), what="the complete prefix records")

    @staticmethod
    def _coords(dht, prefix: str) -> set:
        entry = dht.get(prefix)
        return set() if entry is None else {key for key in entry.value if isinstance(key, int)}

    def close(self):
        for dht_or_server in (self.jax_client_dht, self.client_dht, self.jax_server, self.jax_dht, self.server,
                              self.dht):
            dht_or_server.shutdown()


@pytest.fixture(scope="module")
def grid():
    with deadline(90):
        swarm = MixedGrid()
    yield swarm
    swarm.close()


def grid_scores(rng, batch: int):
    return [rng.randn(batch, size).astype(np.float32) for size in GRID]


# ------------------------------------------------------------------ beam search


def test_both_searchers_choose_the_same_experts_as_the_exhaustive_top_k(grid):
    scores = grid_scores(np.random.RandomState(0), 8)
    beam = 5
    with deadline(30):
        ours = MoEBeamSearcher(grid.client_dht, PREFIX, GRID).batch_find_best_experts(scores, beam)
        theirs = JaxMoEBeamSearcher(grid.jax_client_dht, PREFIX, GRID).batch_find_best_experts(scores, beam)
    assert len(ours) == len(theirs) == 8
    for sample, (mine, expected) in enumerate(zip(ours, theirs)):
        assert [(i.uid, i.peer_id.to_bytes(), i.compression) for i in mine] == \
               [(i.uid, i.peer_id.to_bytes(), i.compression) for i in expected]
        total = {uid: sum(scores[d][sample, int(c)] for d, c in enumerate(uid[len(PREFIX):].split(".")))
                 for uid in grid.uids}
        assert [info.uid for info in mine] == sorted(total, key=lambda uid: -total[uid])[:beam]
    owner = {uid: (grid.dht if uid in grid.server.backends else grid.jax_dht).peer_id.to_bytes() for uid in grid.uids}
    assert all(info.peer_id.to_bytes() == owner[info.uid] for row in ours for info in row)


def test_beam_search_caches_dead_prefixes(grid):
    with deadline(30):
        searcher = MoEBeamSearcher(grid.client_dht, PREFIX, GRID)
        scores = [np.array([0.0, 0.0, 0.0, 50.0], np.float32), np.array([3.0, 2.0, 1.0, 0.0], np.float32)]
        found = searcher.find_best_experts(scores, beam_size=4)
        # row 3 scores best but holds no expert: the DHT lists only declared coordinates
        assert [info.uid for info in found] == ["mx.0.0", "mx.1.0", "mx.2.0", "mx.0.1"]
        ghost = MoEBeamSearcher(grid.client_dht, "ghost.", GRID)
        assert ghost.find_best_experts([np.ones(4, np.float32)] * 2, beam_size=2) == []
        assert "ghost" in ghost._negative_cache
        assert ghost.find_best_experts([np.ones(4, np.float32)] * 2, beam_size=2) == []
        again = searcher.find_best_experts(scores, beam_size=4)
    assert [info.uid for info in again] == [info.uid for info in found]


# ------------------------------------------------------------------ RemoteCallMany


def _experts(grid, uids):
    return [RemoteExpert(info, grid.client_dht.node.p2p) for info in get_experts(grid.client_dht, uids)]


def test_call_many_masks_a_dead_expert_and_raises_under_k_min(grid):
    x = np.random.RandomState(2).randn(4, HID).astype(np.float32)
    with deadline(60):
        good = _experts(grid, ["mx.0.0", "mx.0.1"])
        dead = RemoteExpert(ExpertInfo("mx.9.9", grid.dht.peer_id, "none"), grid.client_dht.node.p2p)
        rows = [[good[0], dead], [good[1], dead], [good[0], good[1]], [good[1], None]]
        x_t = torch.tensor(x, requires_grad=True)
        outputs, alive = RemoteCallMany(rows, k_min=1, forward_timeout=20)(x_t)
        assert outputs.shape == (4, 2, HID) and alive.dtype == torch.bool
        assert alive.tolist() == [[True, False], [True, False], [True, True], [True, False]]
        for sample, row in enumerate(rows):
            for slot, expert in enumerate(row):
                expected = grid.twins[expert.uid].forward(x[sample:sample + 1])[0][0] if alive[sample, slot] else 0
                np.testing.assert_allclose(outputs[sample, slot].detach().numpy(), expected, atol=TOL)
        (outputs ** 2).sum().backward()
        expected_grad = np.zeros_like(x)
        for sample, row in enumerate(rows):
            for slot, expert in enumerate(row):
                if alive[sample, slot]:
                    out = outputs[sample, slot].detach().numpy()[None]
                    expected_grad[sample] += grid.twins[expert.uid].backward(x[sample:sample + 1], 2 * out)[0][0]
        np.testing.assert_allclose(x_t.grad.numpy(), expected_grad, atol=TOL)
        with pytest.raises(RuntimeError, match=r"samples \[0\] got fewer than k_min=2"):
            RemoteCallMany([[good[0], dead]], k_min=2, forward_timeout=10)(torch.tensor(x[:1]))


def test_call_many_abandons_a_straggler_and_feeds_its_breaker(grid):
    x = torch.tensor(np.random.RandomState(3).randn(2, HID).astype(np.float32))
    with deadline(60):
        fast, slow = _experts(grid, ["mx.0.0", "mx.2.2"])
        CHAOS.configure("moe.forward:delay:delay=5:scope=mx.2.2")
        started = time.perf_counter()
        _outputs, alive = RemoteCallMany([[fast, slow], [fast, slow]], k_min=1, timeout_after_k_min=0.3)(x)
        elapsed = time.perf_counter() - started
    assert alive.tolist() == [[True, False], [True, False]] and elapsed < 4.0  # the delay is 5 s
    assert failures("mx.2.2") == 1 and failures("mx.0.0") == 0


def test_call_many_counts_a_shed_once(grid):
    """A server's shed is fed to the breaker by RemoteExpert._call; the fan-out must
    not count it again."""
    backend = expert_pair("shed.0", seed=1)[1]
    with deadline(60):
        dht = DHT(initial_peers=[str(m) for m in grid.dht.get_visible_maddrs()], start=True)
        server = Server(dht, {"shed.0": backend}, max_queue_size=0, activation_compression="none")
        try:
            server.run_in_background(await_ready=True, timeout=30)
            wait_for(lambda: get_experts(grid.client_dht, ["shed.0"])[0] is not None, what="the declaration")
            [expert] = _experts(grid, ["shed.0"])
            _outputs, alive = RemoteCallMany([[expert]], k_min=0)(torch.ones(1, HID))
        finally:
            server.shutdown()
            dht.shutdown()
    assert alive.tolist() == [[False]]
    assert failures("shed.0") == 1


# ------------------------------------------------------------------ the mixtures


def _port_run(moe, x: np.ndarray, w: np.ndarray):
    x_t = torch.tensor(x, requires_grad=True)
    out = moe(x_t)
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), x_t.grad.numpy(), moe.proj.grad.numpy()


@pytest.mark.parametrize("kind", ["mixture", "switch"])
def test_mixtures_agree_across_packages(grid, kind):
    """The same gate, experts and batch through each package's layer: outputs, the
    input gradient and the gate gradient agree; the switch layers' jitter draws
    and utilization too. The JAX gradients differentiate its ``_mix`` on the
    routing its forward chose (its beam search takes concrete scores)."""
    rng = np.random.RandomState(5)
    x, w = rng.randn(6, HID).astype(np.float32), rng.randn(6, HID).astype(np.float32)
    options = dict(in_features=HID, grid_size=GRID, uid_prefix=PREFIX, k_best=3, seed=4)
    with deadline(60):
        if kind == "mixture":
            ours = RemoteMixtureOfExperts(dht=grid.client_dht, device="cpu", **options)
            theirs = JaxRemoteMixtureOfExperts(dht=grid.jax_client_dht, **options)
            noise = np.ones((6, 1), np.float32)
        else:
            ours = RemoteSwitchMixtureOfExperts(dht=grid.client_dht, device="cpu", **options)
            theirs = JaxRemoteSwitchMixtureOfExperts(dht=grid.jax_client_dht, **options)
            noise = np.random.RandomState(theirs.beam_size).uniform(0.99, 1.01, size=(6, 1)).astype(np.float32)
        np.testing.assert_array_equal(ours.proj.detach().numpy(), np.asarray(theirs.proj))
        out, grad_x, grad_proj = _port_run(ours, x, w)
        expected = np.asarray(theirs(jnp.asarray(x)))
        scores = theirs._split_scores((jnp.asarray(x) * noise) @ theirs.proj)
        chosen = theirs.beam_searcher.batch_find_best_experts([np.asarray(s) for s in scores], theirs.beam_size)

        def loss(xx, proj):
            return jnp.sum(theirs._mix(xx, theirs._split_scores((xx * noise) @ proj), chosen) * w)

        jax_grad_x, jax_grad_proj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), theirs.proj)
    assert ours.last_alive.all() and [len(row) for row in ours.last_experts] == [3] * 6
    np.testing.assert_allclose(out, expected, atol=TOL)
    np.testing.assert_allclose(grad_x, np.asarray(jax_grad_x), atol=TOL)
    np.testing.assert_allclose(grad_proj, np.asarray(jax_grad_proj), atol=TOL)
    if kind == "switch":
        for mine, expected_utilization in zip(ours.grid_utilization, theirs.grid_utilization):
            np.testing.assert_array_equal(mine, expected_utilization)


def test_switch_grid_dropout_matches_across_packages(grid):
    """Grid dropout draws the same keep masks in both packages (never a whole
    dimension), routes around the dropped coordinates, and moves the utilization
    EMA identically."""
    x = np.random.RandomState(6).randn(5, HID).astype(np.float32)
    options = dict(in_features=HID, grid_size=GRID, uid_prefix=PREFIX, grid_dropout=0.5, seed=2, beam_size=3)
    with deadline(60):
        ours = RemoteSwitchMixtureOfExperts(dht=grid.client_dht, device="cpu", **options)
        theirs = JaxRemoteSwitchMixtureOfExperts(dht=grid.jax_client_dht, **options)
        for _ in range(3):
            with torch.no_grad():
                out = ours(torch.tensor(x)).numpy()
            np.testing.assert_allclose(out, np.asarray(theirs(jnp.asarray(x))), atol=TOL)
    for mine, expected in zip(ours.grid_utilization, theirs.grid_utilization):
        np.testing.assert_array_equal(mine, expected)


# ------------------------------------------------------------------ the monitor


def test_each_packages_monitor_reads_the_others_snapshots(grid):
    with deadline(60):
        ours = TelemetryPublisher(grid.dht, interval=60, start=False)
        theirs = JaxTelemetryPublisher(grid.jax_dht, interval=60, start=False)
        assert ours.publish_once() and theirs.publish_once()
        peers = {str(grid.dht.peer_id), str(grid.jax_dht.peer_id)}
        wait_for(lambda: peers <= set(fetch_swarm_telemetry(grid.client_dht))
                 and peers <= set(jax_fetch_swarm_telemetry(grid.jax_client_dht)), what="both snapshots")
        mine, expected = fetch_swarm_telemetry(grid.client_dht), jax_fetch_swarm_telemetry(grid.jax_client_dht)
        assert {peer: mine[peer] for peer in peers} == {peer: expected[peer] for peer in peers}
        assert mine[str(grid.dht.peer_id)] == ours.last_published
        view = SwarmMonitor(grid.client_dht).poll()
        jax_view = JaxSwarmMonitor(grid.jax_client_dht).poll()
    assert view["num_peers"] == jax_view["num_peers"] >= 2 and view["metrics"] == jax_view["metrics"]
    board = SwarmMonitor(grid.client_dht).render_serving_board(view)
    assert board == JaxSwarmMonitor(grid.jax_client_dht).render_serving_board(view)
    assert "serving board" in board and "mx." in board
    report = SwarmMonitor(grid.client_dht).render_report(view)
    assert report.startswith(f"swarm telemetry: {view['num_peers']} peers")
