"""PyTorch port vs JAX package: telemetry (registry and Prometheus text, spans and
their wire context, the serving and round ledgers, the step timeline, the
black-box spool, peer snapshots, the compile tracker, the watchdog, the memory
sampler) and the served path's hooks (TaskPool, Runtime, ModuleBackend,
DecodeSessionManager), on the CPU.

Each side gets a fresh registry or ledger where the API takes one, the same
seeded span ids and the same fake clock; text and wire bytes must be identical,
records and counters equal. The served-path hooks write to each package's
process-wide registry, so those tests read deltas."""

import asyncio
import os
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import optax
import pytest
import torch

import hivemind_tpu.telemetry as jax_telemetry
import hivemind_tpu_torch.telemetry as torch_telemetry
from hivemind_tpu.moe.server.decode_session import DecodeSessionManager as JaxDecodeSessionManager
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu.moe.server.runtime import Runtime as JaxRuntime
from hivemind_tpu.moe.server.task_pool import ServerOverloadedError as JaxServerOverloadedError
from hivemind_tpu.moe.server.task_pool import TaskPool as JaxTaskPool
from hivemind_tpu.resilience import BreakerBoard as JaxBreakerBoard
from hivemind_tpu.resilience import reset_all_boards as jax_reset_all_boards
from hivemind_tpu.telemetry import blackbox as jax_blackbox
from hivemind_tpu.telemetry import device as jax_device
from hivemind_tpu.telemetry import exporter as jax_exporter
from hivemind_tpu.telemetry import ledger as jax_ledger
from hivemind_tpu.telemetry import monitor as jax_monitor
from hivemind_tpu.telemetry import registry as jax_registry
from hivemind_tpu.telemetry import serving as jax_serving
from hivemind_tpu.telemetry import tracing as jax_tracing
from hivemind_tpu.telemetry import watchdog as jax_watchdog
from hivemind_tpu_torch.convert import from_flax_params
from hivemind_tpu_torch.moe.server.decode_session import DecodeSessionManager
from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend
from hivemind_tpu_torch.moe.server.runtime import Runtime
from hivemind_tpu_torch.moe.server.task_pool import ServerOverloadedError, TaskPool
from hivemind_tpu_torch.ops import _build
from hivemind_tpu_torch.resilience import BreakerBoard
from hivemind_tpu_torch.resilience import reset_all_boards
from hivemind_tpu_torch.telemetry import blackbox as torch_blackbox
from hivemind_tpu_torch.telemetry import device as torch_device
from hivemind_tpu_torch.telemetry import exporter as torch_exporter
from hivemind_tpu_torch.telemetry import ledger as torch_ledger
from hivemind_tpu_torch.telemetry import monitor as torch_monitor
from hivemind_tpu_torch.telemetry import registry as torch_registry
from hivemind_tpu_torch.telemetry import serving as torch_serving
from hivemind_tpu_torch.telemetry import tracing as torch_tracing
from hivemind_tpu_torch.telemetry import watchdog as torch_watchdog
from hivemind_tpu_torch.utils import asyncio_utils
from hivemind_tpu_torch.utils.profiling import device_memory_stats

torch.set_num_threads(1)

SIDES = {
    "jax": types.SimpleNamespace(
        telemetry=jax_telemetry, registry=jax_registry, tracing=jax_tracing, exporter=jax_exporter,
        serving=jax_serving, ledger=jax_ledger, device=jax_device, monitor=jax_monitor, blackbox=jax_blackbox,
        watchdog=jax_watchdog, BreakerBoard=JaxBreakerBoard, reset_all_boards=jax_reset_all_boards),
    "torch": types.SimpleNamespace(
        telemetry=torch_telemetry, registry=torch_registry, tracing=torch_tracing, exporter=torch_exporter,
        serving=torch_serving, ledger=torch_ledger, device=torch_device, monitor=torch_monitor,
        blackbox=torch_blackbox, watchdog=torch_watchdog, BreakerBoard=BreakerBoard,
        reset_all_boards=reset_all_boards),
}


def _clear(side) -> None:
    side.tracing.RECORDER.clear()
    side.ledger.LEDGER.clear()
    side.serving.SERVING_LEDGER.clear()
    side.serving.SCORECARDS.clear()
    side.device.reset_device_telemetry()
    side.reset_all_boards()
    side.watchdog.shutdown_all()


@pytest.fixture(autouse=True)
def _clean_port_singletons():
    """The port's process-wide telemetry, reset as tests/conftest.py resets the
    JAX package's."""
    _clear(SIDES["torch"])
    yield
    _clear(SIDES["torch"])
    torch_tracing.set_telemetry_time_source(None)


class FakeClock:
    def __init__(self, start: float = 1_700_000_000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


@pytest.fixture
def clock():
    """One fake clock for both packages' spans, ledgers and spools, and the same
    seeded span ids."""
    fake = FakeClock()
    for side in SIDES.values():
        side.tracing.set_telemetry_time_source(fake)
        side.tracing.seed_trace_ids(1234)
    yield fake
    for side in SIDES.values():
        side.tracing.set_telemetry_time_source(None)
        side.tracing.seed_trace_ids(int.from_bytes(os.urandom(8), "big"))


def _value(registry, name: str, **labels) -> float:
    metric = registry.get(name)
    return 0.0 if metric is None else metric.labels(**labels).value


def _histogram(registry, name: str, **labels):
    metric = registry.get(name)
    if metric is None:
        return [0] * 1, 0.0, 0
    return metric.labels(**labels).snapshot()


# ------------------------------------------------------------------ registry


@pytest.mark.parametrize("case", ["mixed", "escaping"])
def test_prometheus_text_is_byte_identical(case):
    rendered = {}
    for name, side in SIDES.items():
        registry = side.registry.MetricsRegistry()
        if case == "mixed":
            counter = registry.counter("parity_requests", "requests served", ("expert", "kind"))
            counter.inc(expert="e0", kind="forward")
            counter.inc(2.5, expert="e1", kind="backward")
            registry.counter("parity_bytes_total", "bytes").inc(1 << 40)
            gauge = registry.gauge("parity_depth", "queue depth", ("pool",))
            gauge.set(3, pool="a")
            gauge.dec(pool="b")
            gauge.set(float("inf"), pool="c")
            gauge.set(1e-7, pool="d")
            latency = registry.histogram("parity_latency_seconds", "latency", ("pool",))
            for value in (0.0004, 0.02, 7.0, 100.0, 0.001):
                latency.observe(value, pool="a")
            occupancy = registry.histogram("parity_occupancy", "occupancy", buckets=(1.0, 0.25, 0.5))
            occupancy.observe(0.3)
            with registry.histogram("parity_timer_seconds", "timed").time():
                pass
        else:
            counter = registry.counter("parity_escaped_total", 'help with "quotes" and \\ backslash\nnewline', ("label",))
            counter.inc(label='quote " backslash \\ newline \n end')
            counter.inc(label="")
            registry.gauge("parity_empty", "").set(0)
        text = side.exporter.render_prometheus(registry)
        snapshot = registry.snapshot()
        if case == "mixed":  # the timer's value differs run to run; its shape does not
            text = "\n".join(line for line in text.splitlines() if "parity_timer_seconds_sum" not in line)
            snapshot["parity_timer_seconds"]["series"]["_"]["sum"] = None
        rendered[name] = (text, snapshot)
    assert rendered["jax"] == rendered["torch"]
    assert "parity_requests_total{" in rendered["torch"][0] or case == "escaping"


def test_registry_defaults_and_type_checks_match():
    assert torch_registry.DEFAULT_BUCKETS == jax_registry.DEFAULT_BUCKETS
    for side in SIDES.values():
        registry = side.registry.MetricsRegistry()
        registry.counter("parity_once", "", ("a",))
        with pytest.raises(AssertionError):
            registry.gauge("parity_once")
        with pytest.raises(AssertionError):
            registry.counter("parity_once", "", ("b",))


# ------------------------------------------------------------------ spans


def _span_tree(side, clock):
    """A request span with a child, events, attributes and an error, on the clock."""
    tracing = side.tracing
    with tracing.trace("serving.request", kind="forward", expert="e0", peer="p0", client="c1", batch=2) as root:
        clock.advance(0.001)
        root.add_event("chaos.delay", point="moe.forward")
        with tracing.trace("moe.forward", peer="p0") as child:
            clock.advance(0.002)
            child.set("rows", 2)
        with tracing.trace("allreduce.round", peer="p0", group_size=2):
            clock.advance(0.0005)
        root.set("queue_wait_s", 0.0005)
        clock.advance(0.001)
    try:
        with tracing.trace("dht.get", peer="p1", remote_context=(7, 9)):
            clock.advance(0.003)
            raise KeyError("missing")
    except KeyError:
        pass
    detached = tracing.start_span("stream.part", parent=root, part=3)
    clock.advance(0.0002)
    tracing.finish_span(detached)
    return root, tracing.RECORDER.snapshot()


def test_trace_context_and_chrome_trace_are_identical(clock):
    out = {}
    for name, side in SIDES.items():
        side.tracing.RECORDER.clear()
        side.tracing.seed_trace_ids(1234)
        start = clock.now
        root, spans = _span_tree(side, clock)
        clock.now = start  # both sides run on the same timeline
        wire = side.tracing.pack_context(root)
        out[name] = (wire, side.tracing.unpack_context(wire), side.tracing.unpack_context(b"\x00" * 16),
                     side.tracing.unpack_context(b"short"), side.tracing.render_chrome_trace_json(spans),
                     [span.summary() for span in spans])
    assert out["jax"] == out["torch"]
    wire, context = out["torch"][:2]
    assert len(wire) == 16 and context == (int.from_bytes(wire[:8], "big"), int.from_bytes(wire[8:], "big"))
    assert '"lane": "comm"' in out["torch"][4]


# ------------------------------------------------------------------ ledgers


class _ShedError(RuntimeError):
    pass


_ShedError.__name__ = "ServerOverloadedError"


def _serving_spans(side, clock, ledger):
    tracing, serving = side.tracing, side.serving
    for i in range(9):
        try:
            with tracing.trace(serving.SERVING_SPAN, kind="forward" if i % 3 else "backward", expert=f"e{i % 2}",
                               peer="p0", client=f"c{i % 4}", batch=1 + i % 3) as span:
                clock.advance(0.001 * (i + 1))
                serving.accrue_span_phase("queue_wait_s", 0.0001 * i)
                serving.accrue_span_phase("assembly_s", 0.00005)
                serving.accrue_span_phase("compute_s", 0.0007 * (i + 1))
                serving.accrue_span_phase("compute_s", 0.0001)  # a second pool of the chain
                span.set("occupancy", 0.25 * (1 + i % 4))
                span.set("pool", f"e{i % 2}.forward")
                if i == 4:
                    raise _ShedError("queue full")
                if i == 7:
                    raise ValueError("bad input")
        except RuntimeError:
            pass
        except ValueError:
            pass
        ledger.on_span(span)
    with tracing.trace("moe.forward"):  # not a serving span: ignored
        clock.advance(0.001)


def test_serving_ledger_and_scorecards_match(clock):
    out = {}
    for name, side in SIDES.items():
        side.tracing.seed_trace_ids(99)
        start = clock.now
        scorecards = side.serving.ExpertScorecards(window=8)
        ledger = side.serving.ServingLedger(registry=side.registry.MetricsRegistry(), scorecards=scorecards,
                                            slowest_capacity=3)
        _serving_spans(side, clock, ledger)
        for i in range(12):
            error = None if i % 5 else (_ShedError("shed") if i % 2 else asyncio.TimeoutError())
            scorecards.record(f"e{i % 3}", 0.01 * (i + 1), ok=error is None, kind="forward", error=error)
        scorecards.record("e9", 0.5, ok=False, error=ConnectionError("reset"))
        clock.now = start
        out[name] = (ledger.summary(), ledger.records(), ledger.expert_stats(), ledger.client_stats(),
                     ledger.slowest(), scorecards.snapshot(), scorecards.card("e0"), ledger.export())
    assert out["jax"] == out["torch"]
    summary = out["torch"][0]
    assert summary["requests"] == 9 and summary["sheds"] == 1 and summary["errors"] == 2


def _round_spans(side, clock, peer="A"):
    tracing = side.tracing
    for round_index in range(3):
        with tracing.trace("averaging.matchmaking", peer=peer, outcome="ok"):
            clock.advance(0.01 * (round_index + 1))
        with tracing.trace("allreduce.round", peer=peer, group_size=3, rank=round_index % 3) as round_span:
            with tracing.trace("allreduce.local_reduce", peer=peer):
                clock.advance(0.002)
            for remote, seconds in (("B", 0.01), ("C", 0.03 * (round_index + 1))):
                with tracing.trace("allreduce.peer_exchange", peer=peer, remote=remote, codec="fp16") as exchange:
                    clock.advance(seconds)
                    if remote == "C":
                        exchange.add_event("retry")
        if round_index == 1:  # a slower exchange that lands after its round closed
            late = tracing.start_span("allreduce.peer_exchange", parent=round_span, remote="D")
            clock.advance(0.2)
            tracing.finish_span(late)


def test_round_ledger_and_step_timeline_match(clock):
    out = {}
    for name, side in SIDES.items():
        side.tracing.seed_trace_ids(5)
        start = clock.now
        ledger = side.ledger.RoundLedger(registry=side.registry.MetricsRegistry())
        timeline = side.device.StepTimeline()
        side.tracing.add_span_listener(ledger.on_span)
        side.tracing.add_span_listener(timeline.on_span)
        try:
            with side.tracing.trace("device.compute", peer="A"):
                clock.advance(0.05)
            _round_spans(side, clock)
            with side.tracing.trace("averaging.aggregate", peer="A"):
                clock.advance(0.01)
            with side.tracing.trace("optimizer.step", peer="A", epoch=4):
                clock.advance(0.001)
                timeline.note_grad_ready("A")
                clock.advance(0.001)
        finally:
            side.tracing.remove_span_listener(ledger.on_span)
            side.tracing.remove_span_listener(timeline.on_span)
        ledger.note_overlap("A", 0.375)
        epoch = ledger.record_epoch(4, peer="A", averaged_ok=True, num_peers=3)
        clock.now = start
        out[name] = (ledger.records(), ledger.epochs(), epoch, ledger.straggler_scores(), ledger.summary(),
                     ledger.snapshot(), timeline.records(), timeline.overlap_summary(), timeline.steps(),
                     timeline.summary())
    assert out["jax"] == out["torch"]
    records, _epochs, epoch = out["torch"][:3]
    assert len(records) == 3 and epoch["rounds"] == 3 and out["torch"][7]["rounds"] == 3 + 3 + 1  # comm spans


# ------------------------------------------------------------------ black box


def test_blackbox_spool_bytes_are_identical_and_each_reads_the_other(clock, tmp_path):
    frames = [
        ("span", {"name": "serving.request", "dur_ms": 1.25, "attrs": {"batch": 2, "ok": True}}),
        ("ledger_round", {"round": 1, "peer": "A", "exchanges": [{"remote": "B", "dur_s": 0.01}], "x": None}),
        ("metrics", {"hivemind_moe_batches_total": {"type": "counter", "series": {"pool=a": 3.0}}}),
        ("device", {"kind": "compile", "site": "build.flash_attention", "dur_s": 12.5}),
    ]
    segments = {}
    for name, side in SIDES.items():
        start = clock.now
        writer = side.blackbox.SpoolWriter(tmp_path / name, peer="p0", segment_bytes=400, retention_segments=4)
        for index in range(6):
            kind, data = frames[index % len(frames)]
            writer.append(kind, {**data, "i": index})
            clock.advance(0.5)
        writer.close()
        clock.now = start
        segments[name] = {path.name: path.read_bytes() for path in sorted((tmp_path / name).iterdir())}
    assert segments["jax"] == segments["torch"] and len(segments["torch"]) >= 2
    readings = {(reader, written): SIDES[reader].blackbox.read_spool(tmp_path / written)
                for reader in SIDES for written in SIDES}
    assert len({repr(reading) for reading in readings.values()}) == 1
    frames_read, stats = readings[("torch", "jax")]
    assert [frame["k"] for frame in frames_read].count("header") == len(segments["jax"])
    assert stats["frames"] == len(frames_read)


# ------------------------------------------------------------------ snapshots


def _snapshot_activity(side, clock):
    """The same process-wide activity in either package: spans, a tripped
    breaker, transfers, a compile and a few metrics."""
    _clear(side)
    side.tracing.seed_trace_ids(42)
    side.tracing.RECORDER.slow_threshold = 0.01
    _serving_spans(side, clock, side.serving.ServingLedger(registry=side.registry.MetricsRegistry()))
    _round_spans(side, clock)
    board = side.BreakerBoard("parity_snapshot", failure_threshold=1, clock=clock)
    board.register_failure("QmDead")
    side.device.record_transfer(4096, "host_to_device")
    side.device.record_transfer(1024, "device_to_host")
    side.device.COMPILE_TRACKER.record_compile("build.parity", duration_s=1.5, signature="sig")
    registry = side.registry.MetricsRegistry()
    registry.counter("parity_requests", "", ("expert",)).inc(3, expert="e0")
    for i in range(40):
        registry.counter("parity_wide", "", ("peer",)).inc(i, peer=f"peer-{i:03d}")
    registry.histogram("parity_latency_seconds", "", ("pool",)).observe(0.02, pool="a")
    registry.gauge("parity_depth").set(4)
    return board, registry


@pytest.mark.parametrize("budget", [None, 6000, 2500, 900, 200])
def test_peer_snapshot_shrinking_and_swarm_view_match(clock, monkeypatch, budget):
    out = {}
    for name, side in SIDES.items():
        monkeypatch.setattr(side.monitor, "get_dht_time", lambda: 1_700_000_100.0)
        start = clock.now
        board, registry = _snapshot_activity(side, clock)
        snapshot = side.monitor.build_peer_snapshot(registry, extras={"peer_id": "p0"})
        if budget is not None:
            snapshot = side.monitor._shrink_to_fit(snapshot, max_bytes=budget)
        other = {**snapshot, "peer_id": "p1", "metrics": {"parity_depth": {"type": "gauge", "series": {"_": 9.0}}},
                 "time": 1_700_000_040.0}
        view = side.monitor.aggregate_swarm_view({"p0": snapshot, "p1": other, "bad": {"metrics": 5, "time": "x"}})
        compacted = side.monitor._compact_family(registry.snapshot()["parity_wide"])
        out[name] = (snapshot, view, compacted)
        board.clear()
        side.tracing.RECORDER.slow_threshold = 10.0
        clock.now = start
    assert out["jax"] == out["torch"]
    snapshot, view, _ = out["torch"]
    assert view["num_peers"] == 3 and view["peers"]["bad"]["malformed"]
    if budget is None:
        assert {"breakers", "ledger", "serving", "device", "slow_spans"} <= set(snapshot)
    else:
        assert snapshot.get("truncated") or budget >= 6000


# ------------------------------------------------------------------ compiles


def test_compile_tracker_storm_detection_matches(clock):
    out = {}
    schedule = [(0.0, "build.a"), (1.0, "build.a"), (1.5, "build.b"), (2.0, "build.a"), (3.0, "build.a"),
                (20.0, "build.a"), (21.0, "build.a"), (22.0, "build.a"), (22.5, "build.b")]
    for name, side in SIDES.items():
        tracker = side.device.JitCompileTracker(storm_threshold=3, storm_window_s=10.0)
        records = []
        listener = lambda kind, record: records.append((kind, dict(record)))  # noqa: E731
        side.device.add_device_listener(listener)
        registry = side.registry.REGISTRY
        before = {site: _value(registry, "hivemind_device_recompile_storms_total", site=site) for site in ("build.a", "build.b")}
        start = clock.now
        try:
            for at, site in schedule:
                clock.now = start + at
                tracker.record_compile(site, duration_s=0.25, signature=f"{site}.so")
        finally:
            side.device.remove_device_listener(listener)
            clock.now = start
        storms = {site: _value(registry, "hivemind_device_recompile_storms_total", site=site) - before[site]
                  for site in before}
        out[name] = (tracker.summary(), tracker.storm_count(), tracker.counts(), tracker.total(), records, storms)
    assert out["jax"] == out["torch"]
    assert out["torch"][1] == 2 and out["torch"][3] == len(schedule)


def test_kernel_builds_are_the_compile_events_and_cached_libraries_are_not(tmp_path, monkeypatch):
    """A fake nvcc writes each library: every build counts one compile under
    build.<source>; a second build_all finds them all built and counts none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho built > "$2"\necho "ptxas info"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    tracker = torch_device.COMPILE_TRACKER
    registry = torch_registry.REGISTRY
    before = {name: _value(registry, "hivemind_device_compiles_total", site=f"build.{name}") for name in _build.SOURCES}
    _build.build_all()
    counts = {name: _value(registry, "hivemind_device_compiles_total", site=f"build.{name}") - before[name]
              for name in _build.SOURCES}
    assert counts == {name: 1 for name in _build.SOURCES}
    assert tracker.counts() == {f"build.{name}": 1 for name in _build.SOURCES}
    assert tracker.summary()["sites"]["build.flash_attention"]["signature"] == _build.library_path("flash_attention").name
    _build.build_all()  # every library is in the build cache now
    assert tracker.total() == len(_build.SOURCES)
    assert torch_device.device_snapshot()["compiles"]["total"] == len(_build.SOURCES)


# ------------------------------------------------------------------ memory


def test_memory_sampler_creates_no_cuda_context_on_the_cpu():
    assert not torch.cuda.is_initialized()
    assert torch_device.MEMORY_MONITOR.sample() is None
    assert torch_device.DeviceMemoryMonitor().sample(modules={}) is None
    torch_device.arm_device_telemetry()
    torch_device._watchdog_sampler()
    torch_device.disarm_device_telemetry()
    assert device_memory_stats() == {} and device_memory_stats("cpu") == {}
    assert not torch.cuda.is_initialized()
    assert torch_device.device_snapshot() == {}


class _FakeArray:
    def __init__(self, device, nbytes):
        self._device, self.nbytes = device, nbytes

    def devices(self):
        return [self._device]


class _FakeJaxDevice:
    def __init__(self, sequence):
        self.sequence = sequence

    def __str__(self):
        return "cuda:0"

    def memory_stats(self):
        allocated, _buffers, peak, reserved = self.sequence[0]
        return {"peak_bytes_in_use": peak, "bytes_in_use": reserved}


def _fake_modules(sequence):
    """A torch with an initialized CUDA allocator, and a jax whose live arrays
    hold the same bytes, both reading ``sequence[0]``."""
    cuda = types.SimpleNamespace(
        is_initialized=lambda: True, device_count=lambda: 1,
        memory_allocated=lambda i: sequence[0][0], max_memory_allocated=lambda i: sequence[0][2],
        memory_reserved=lambda i: sequence[0][3],
        memory_stats=lambda i: {"allocation.all.current": sequence[0][1]})
    device = _FakeJaxDevice(sequence)

    def live_arrays():
        allocated, buffers, _peak, _reserved = sequence[0]
        return [_FakeArray(device, allocated // buffers)] * buffers

    return {"torch": types.SimpleNamespace(cuda=cuda)}, {"jax": types.SimpleNamespace(live_arrays=live_arrays)}


def test_memory_sampler_reads_the_allocator_and_its_leak_heuristic_matches_jax():
    samples = [(1 << 20, 4, 2 << 20, 4 << 20)] + [((2 + i) << 22, 8, (3 + i) << 22, 64 << 20) for i in range(9)]
    current = [samples[0]]
    torch_modules, jax_modules = _fake_modules(current)
    port, reference = torch_device.DeviceMemoryMonitor(leak_samples=4), jax_device.DeviceMemoryMonitor(leak_samples=4)
    readings = []
    for sample in samples:
        current[0] = sample
        ours, theirs = port.sample(modules=torch_modules), reference.sample(modules=jax_modules)
        assert ours == theirs
        readings.append(ours)
    assert port.leak_count() == reference.leak_count() == 2
    last = readings[-1]["devices"]["cuda:0"]
    assert last == {"bytes": samples[-1][0], "buffers": 8, "peak_bytes": samples[-1][2],
                    "backend_bytes_in_use": samples[-1][3]}
    registry = torch_registry.REGISTRY
    assert _value(registry, "hivemind_device_memory_bytes", device="cuda:0") == samples[-1][0]
    assert _value(registry, "hivemind_device_memory_peak_bytes", device="cuda:0") == samples[-1][2]
    assert _value(registry, "hivemind_device_live_buffers", device="cuda:0") == 8


# ------------------------------------------------------------------ watchdog


@pytest.mark.parametrize("package", ["jax", "torch"])
async def test_watchdog_counts_one_stall_for_a_blocked_loop(package):
    watchdog_module = SIDES[package].watchdog
    registry = SIDES[package].registry.MetricsRegistry()
    watchdog = watchdog_module.EventLoopWatchdog(asyncio.get_running_loop(), name="parity", interval=0.01,
                                                 stall_threshold=0.15, registry=registry)
    try:
        await asyncio.sleep(0.1)  # heartbeats land: the loop thread is identified
        time.sleep(0.6)  # blocks the loop past the threshold: ONE stall episode
        await asyncio.sleep(0.1)
    finally:
        watchdog.shutdown()
    assert watchdog.stalls == 1
    assert _value(registry, "hivemind_event_loop_stalls_total", loop="parity") == 1
    assert "time.sleep(0.6)" in watchdog.last_stall["frame"]
    assert watchdog.max_lag >= 0.5
    _buckets, _total, count = _histogram(registry, "hivemind_event_loop_lag_seconds", loop="parity")
    assert count >= 3


async def test_watchdog_reads_a_backlog_queued_on_the_ports_executor():
    release = threading.Event()
    workers = asyncio_utils._blocking_executor._max_workers
    futures = [asyncio_utils._blocking_executor.submit(release.wait, 10) for _ in range(workers + 5)]
    try:
        deadline = time.monotonic() + 5
        while torch_watchdog._executor_queue_depths().get("blocking") != 5 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        registry = torch_registry.MetricsRegistry()
        watchdog = torch_watchdog.EventLoopWatchdog(asyncio.get_running_loop(), name="backlog", registry=registry,
                                                    start=False)
        watchdog._sample_executors()
        assert _value(registry, "hivemind_executor_queue_depth", executor="blocking") == 5
        assert set(torch_watchdog._executor_queue_depths()) == {"blocking"}
    finally:
        release.set()
        for future in futures:
            future.result(timeout=10)


def test_exporter_serves_the_ports_metrics_and_spans(clock):
    registry = torch_registry.MetricsRegistry()
    registry.counter("parity_scraped", "", ("pool",)).inc(7, pool="a")
    exporter = torch_exporter.MetricsExporter(port=0, registry=registry)
    try:
        _span_tree(SIDES["torch"], clock)
        base = f"http://127.0.0.1:{exporter.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        trace = urllib.request.urlopen(base + "/trace", timeout=10).read().decode()
        serving = urllib.request.urlopen(base + "/serving", timeout=10).read().decode()
    finally:
        exporter.shutdown()
    assert text == torch_exporter.render_prometheus(registry) and 'parity_scraped_total{pool="a"} 7' in text
    assert '"serving.request"' in trace and '"records"' in serving


# ------------------------------------------------------------------ served path

HID = 16


def _random_flax_params(params, rng):
    import jax

    def leaf(path, value):
        name, shape = path[-1].key, np.shape(value)
        if name == "kernel":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[0]), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _backends(block, kwargs, uid, sample):
    """The same random weights in a JAX and a port backend (CPU)."""
    jax_backend = JaxModuleBackend(uid, jax_blocks[block](HID, **kwargs), optimizer=optax.sgd(0.0), sample_input=sample)
    flax_params = _random_flax_params(jax_backend.params, np.random.RandomState(0))
    jax_backend.load_params(flax_params)
    backend = ModuleBackend(uid, name_to_block[block](HID, **kwargs), sample_input=sample, device="cpu",
                            params=from_flax_params(block, flax_params))
    return jax_backend, backend


SERVED_METRICS = (
    ("hivemind_moe_batches_total", "pool"), ("hivemind_moe_samples_total", "pool"),
    ("hivemind_moe_batch_failures_total", "pool"), ("hivemind_moe_shed_total", "pool"),
    ("hivemind_moe_pool_cancelled_skipped_total", "pool"),
)
TRANSFERS = ("host_to_device", "device_to_host")


def _served_reading(registry, pool: str) -> dict:
    reading = {name: _value(registry, name, pool=pool) for name, _label in SERVED_METRICS}
    reading["queue_wait_count"] = _histogram(registry, "hivemind_moe_queue_wait_seconds", pool=pool)[2]
    reading["occupancy_buckets"] = _histogram(registry, "hivemind_moe_batch_occupancy", pool=pool)[0]
    for direction in TRANSFERS:
        reading[direction] = _value(registry, "hivemind_device_transfer_bytes_total", direction=direction)
    return reading


def _delta(after: dict, before: dict) -> dict:
    out = {}
    for key, value in after.items():
        if isinstance(value, list):
            previous = before[key] if len(before[key]) == len(value) else [0] * len(value)
            out[key] = [a - b for a, b in zip(value, previous)]
        else:
            out[key] = value - before[key]
    return out


async def _wait_for(predicate, timeout: float = 20.0) -> None:
    """Counters advance after the callers' results (the drain loop counts a batch
    once its executor call returns): wait for them before reading or stopping."""
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "the runtime never counted its batches"
        await asyncio.sleep(0.005)


async def _drive_served_path(side: str, forward, pool_name: str) -> dict:
    pool_cls, runtime_cls = (JaxTaskPool, JaxRuntime) if side == "jax" else (TaskPool, Runtime)
    overloaded = JaxServerOverloadedError if side == "jax" else ServerOverloadedError
    registry, serving_module = SIDES[side].registry.REGISTRY, SIDES[side].serving
    before = _served_reading(registry, pool_name)
    pool = pool_cls(forward, pool_name, max_batch_size=4, max_queue_size=6)
    rng = np.random.RandomState(3)

    async def request(x):
        with SIDES[side].tracing.trace(serving_module.SERVING_SPAN, kind="forward", expert=pool_name, client="c"):
            return await pool.submit_task(x)

    # wave 1: six single-sample tasks queue before the runtime starts, two more are
    # shed, one queued caller gives up -> batches of 4 and 1 (+1 cancelled skipped)
    first = [asyncio.ensure_future(request(rng.randn(1, HID).astype(np.float32))) for _ in range(8)]
    await asyncio.sleep(0)
    first[5].cancel()
    await asyncio.sleep(0)
    runtime = runtime_cls([pool])
    runtime.start()
    try:
        results = await asyncio.gather(*first, return_exceptions=True)
        await _wait_for(lambda: _value(registry, "hivemind_moe_batches_total", pool=pool_name) - before["hivemind_moe_batches_total"] >= 2)
        # wave 2: two tasks of two samples merge into one full batch
        second = [request(rng.randn(2, HID).astype(np.float32)) for _ in range(2)]
        results += await asyncio.gather(*second)
        await _wait_for(lambda: _value(registry, "hivemind_moe_batches_total", pool=pool_name) - before["hivemind_moe_batches_total"] >= 3)
    finally:
        stopped = runtime.shutdown()
        if asyncio.iscoroutine(stopped):
            await stopped
    kinds = [type(r).__name__ if isinstance(r, BaseException) else "ok" for r in results]
    assert kinds.count(overloaded.__name__) == 2 and kinds.count("CancelledError") == 1
    records = [r for r in serving_module.SERVING_LEDGER.records() if r["expert"] == pool_name]
    return _delta(_served_reading(registry, pool_name), before), kinds, [sorted(r) for r in records]


async def test_served_path_counters_match_the_jax_pool_and_runtime():
    sample = np.zeros((1, HID), np.float32)
    jax_backend, backend = _backends("ffn", {}, "ffn.0", sample)
    jax_backend.forward(np.zeros((4, HID), np.float32))  # compile outside the measured run
    jax_side = await _drive_served_path("jax", jax_backend.forward, "parity.ffn")
    torch_side = await _drive_served_path("torch", backend.forward, "parity.ffn")
    assert jax_side == torch_side
    reading = torch_side[0]
    assert reading["hivemind_moe_batches_total"] == 3 and reading["hivemind_moe_samples_total"] == 9
    assert reading["hivemind_moe_shed_total"] == 2 and reading["hivemind_moe_pool_cancelled_skipped_total"] == 1
    assert reading["queue_wait_count"] == 7
    assert reading["host_to_device"] == reading["device_to_host"] == 9 * HID * 4
    served = [keys for keys in torch_side[2] if "error" not in keys]
    assert len(served) == 7 and all({"queue_wait_s", "assembly_s", "compute_s", "occupancy", "pool"} <= set(keys)
                                    for keys in served)


UTILIZATION_WINDOW_S, REPORT_INTERVAL_S, BATCH_S = 1.0, 2.0, 0.25
IDLE_BEFORE_BATCH_S = (0.5, 0.25, 1.0, 0.0, 0.75, 0.5, 2.0, 0.125)
DEVICE_MEMORY = {"bytes_in_use": 3 * 2**30, "peak_bytes_in_use": 4 * 2**30, "bytes_limit": 80 * 2**30}


async def _drive_runtime_clock(side: str, monkeypatch, pool_name: str):
    """One task at a time through a pool and its Runtime under a fake clock: each
    batch takes BATCH_S of it, the idle time before each submit is scripted. Returns
    the utilization gauge after each batch and the runtime's log lines."""
    import hivemind_tpu.moe.server.runtime as jax_runtime_module
    import hivemind_tpu.utils.profiling as jax_profiling
    import hivemind_tpu_torch.moe.server.runtime as runtime_module

    module = jax_runtime_module if side == "jax" else runtime_module
    registry = SIDES[side].registry.REGISTRY
    clock = FakeClock(100.0)
    monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=clock))
    lines = []
    monkeypatch.setattr(module.logger, "info", lines.append)
    if side == "jax":
        monkeypatch.setattr(jax_profiling, "device_memory_stats", lambda *args: DEVICE_MEMORY)
        runtime_kwargs = {"stats_report_interval": REPORT_INTERVAL_S}
    else:
        monkeypatch.setattr(module, "device_memory_stats", lambda *args: DEVICE_MEMORY)
        monkeypatch.setattr(module, "STATS_REPORT_INTERVAL", REPORT_INTERVAL_S)
        runtime_kwargs = {}

    def forward(x):
        clock.advance(BATCH_S)
        return [x * 2]

    pool_cls, runtime_cls = (JaxTaskPool, JaxRuntime) if side == "jax" else (TaskPool, Runtime)
    pool = pool_cls(forward, pool_name, max_batch_size=4)
    gauge = registry.get("hivemind_moe_runtime_utilization")
    gauge.set(-1.0)  # no window has closed yet
    runtime = runtime_cls([pool], **runtime_kwargs)
    runtime._utilization_window = UTILIZATION_WINDOW_S
    batches = registry.get("hivemind_moe_batches_total").labels(pool_name)
    counted, readings = batches.value, []
    runtime.start()
    try:
        for i, idle in enumerate(IDLE_BEFORE_BATCH_S):
            clock.advance(idle)
            await pool.submit_task(np.full((1 + i % 2, HID), i, np.float32))
            await _wait_for(lambda: batches.value - counted == i + 1)
            readings.append(gauge.value())
    finally:
        stopped = runtime.shutdown()
        if asyncio.iscoroutine(stopped):
            await stopped
    return readings, lines


async def test_runtime_utilization_gauge_and_stats_report_match_the_jax_runtime(monkeypatch):
    jax_readings, jax_lines = await _drive_runtime_clock("jax", monkeypatch, "parity.clock")
    readings, lines = await _drive_runtime_clock("torch", monkeypatch, "parity.clock")
    assert (readings, lines) == (jax_readings, jax_lines)
    # batches end at 0.75, 1.25, 2.5, 2.75, 3.75, 4.5, 6.75 and 7.125 s: a window closes
    # after batches 2, 3, 5 and 7 (busy 0.5 of 1.25 s, 0.25 of 1.25, 0.5 of 1.25, 0.5 of 3)
    assert readings == [-1.0, 0.4, 0.2, 0.2, 0.4, 0.4, 0.1667, 0.1667]
    # reports after batches 3 (2.5 s), 6 (4.5 s) and 7 (6.75 s): the deltas since the last
    assert lines == [
        "[parity.clock] 3 batches, avg size 1.3, 5 samples/s device time", "[device] HBM 3.00 GiB in use / 80.00 GiB",
        "[parity.clock] 3 batches, avg size 1.7, 7 samples/s device time", "[device] HBM 3.00 GiB in use / 80.00 GiB",
        "[parity.clock] 1 batches, avg size 1.0, 4 samples/s device time", "[device] HBM 3.00 GiB in use / 80.00 GiB",
    ]


async def test_mixed_shape_traffic_counts_the_ports_merge_rule():
    """Consecutive tasks of one trailing shape share a batch; a task of another
    shape starts a new one (the JAX pool would fail the merged batch)."""
    registry = torch_registry.REGISTRY
    pool_name = "parity.mixed"
    before = _served_reading(registry, pool_name)
    before_latency = _histogram(registry, "hivemind_moe_batch_latency_seconds", pool=pool_name)[2]
    batches = []
    pool = TaskPool(lambda x: batches.append(x.shape) or [x * 2], pool_name, max_batch_size=8)
    lengths = (4, 4, 8, 4, 4, 4)
    submits = [asyncio.ensure_future(pool.submit_task(np.ones((1, length, HID), np.float32))) for length in lengths]
    await asyncio.sleep(0)
    runtime = Runtime([pool])
    runtime.start()
    try:
        outputs = await asyncio.gather(*submits)
        await _wait_for(lambda: runtime.batches_processed == 3)
    finally:
        await runtime.shutdown()
    assert batches == [(2, 4, HID), (1, 8, HID), (3, 4, HID)]
    assert [out[0].shape[1] for out in outputs] == list(lengths)
    reading = _delta(_served_reading(registry, pool_name), before)
    assert reading["hivemind_moe_batches_total"] == 3 and reading["hivemind_moe_samples_total"] == 6
    assert reading["queue_wait_count"] == 6
    # occupancy 2/8, 1/8 and 3/8 against the buckets (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
    assert reading["occupancy_buckets"] == [0, 0, 2, 3, 3, 3, 3]
    assert _histogram(registry, "hivemind_moe_batch_latency_seconds", pool=pool_name)[2] - before_latency == 3
    assert reading["host_to_device"] == reading["device_to_host"] == 0  # a plain function moves nothing


async def test_module_backend_counts_the_bytes_it_moves():
    sample = np.zeros((1, 3, HID), np.float32)
    backend = ModuleBackend("tx.0", name_to_block["ffn"](HID), sample_input=sample, device="cpu")
    registry = torch_registry.REGISTRY
    before = {direction: _value(registry, "hivemind_device_transfer_bytes_total", direction=direction)
              for direction in TRANSFERS}
    x = np.ones((5, 3, HID), np.float64)  # sent as fp32
    backend.forward(x)
    backend.backward(x, np.ones((5, 3, HID), np.float32))
    moved = {direction: _value(registry, "hivemind_device_transfer_bytes_total", direction=direction) - before[direction]
             for direction in TRANSFERS}
    nbytes = 5 * 3 * HID * 4
    assert moved == {"host_to_device": nbytes + 2 * nbytes, "device_to_host": nbytes + nbytes}


DECODE_METRICS = (
    ("hivemind_moe_decode_session_resets_total", {}),
    ("hivemind_moe_decode_session_evictions_total", {"reason": "ttl"}),
    ("hivemind_moe_decode_session_evictions_total", {"reason": "cap"}),
    ("hivemind_moe_decode_steps_total", {"path": "direct"}),
    ("hivemind_moe_decode_steps_total", {"path": "batched"}),
)


async def _decode_script(manager, uid: str, registry) -> tuple:
    before = [_value(registry, name, **labels) for name, labels in DECODE_METRICS]
    rng = np.random.RandomState(4)
    prompt = lambda length: rng.randn(1, length, HID).astype(np.float32)  # noqa: E731
    token = lambda: rng.randn(1, 1, HID).astype(np.float32)  # noqa: E731
    gauges = []
    read_gauges = lambda: gauges.append((_value(registry, "hivemind_moe_decode_sessions"),  # noqa: E731
                                         _value(registry, "hivemind_moe_decode_session_occupancy")))
    manager.decode(uid, "s1", prompt(3), reset=True)
    await manager.decode_async(uid, "s2", prompt(5), True)
    read_gauges()
    manager.decode(uid, "s1", token(), reset=False)
    await asyncio.gather(manager.decode_async(uid, "s1", token(), False), manager.decode_async(uid, "s2", token(), False))
    await asyncio.gather(manager.decode_async(uid, "s1", token(), False), manager.decode_async(uid, "s2", token(), False))
    manager.decode(uid, "s3", prompt(2), reset=True)
    manager.decode(uid, "s4", prompt(2), reset=True)  # 4 sessions over a cap of 3
    read_gauges()
    manager.decode(uid, "s4", token(), reset=False)  # the cap evicts the least recently used
    read_gauges()
    manager.session_ttl = 0.3  # set only now: the JAX package's first steps compile for longer than that
    time.sleep(0.4)  # past the TTL: the idle sessions expire at the next call
    manager.decode(uid, "s5", prompt(4), reset=True)
    read_gauges()
    with pytest.raises(KeyError, match="reset=True"):
        manager.decode(uid, "s1", token(), reset=False)
    deltas = [_value(registry, name, **labels) - b for (name, labels), b in zip(DECODE_METRICS, before)]
    return deltas, gauges


async def test_decode_session_gauges_and_counters_match_the_jax_manager():
    kwargs = {"num_heads": 4, "num_kv_heads": 2}
    jax_backend, backend = _backends("llama_block", kwargs, "dec.0", np.zeros((1, 4, HID), np.float32))
    settings = dict(max_len=16, session_ttl=600.0, max_sessions=3, merge_recency_s=60.0)
    reference = await _decode_script(JaxDecodeSessionManager({"dec.0": jax_backend}, **settings), "dec.0",
                                     jax_registry.REGISTRY)
    ours = await _decode_script(DecodeSessionManager({"dec.0": backend}, **settings), "dec.0", torch_registry.REGISTRY)
    assert ours == reference
    deltas, gauges = ours
    assert deltas == [5, 3, 1, 7, 4]  # resets; ttl and cap evictions; direct and batched steps
    assert gauges == [(2, round(2 / 3, 4)), (4, round(4 / 3, 4)), (3, 1.0), (1, round(1 / 3, 4))]


def test_no_jax_package_module_is_looked_up_by_the_ports_telemetry():
    """The port's telemetry reads its own executor and pools."""
    assert "hivemind_tpu_torch.utils.asyncio_utils" in sys.modules
    assert "blocking" in torch_watchdog._executor_queue_depths()
    before = _value(torch_registry.REGISTRY, "hivemind_moe_pool_queue_depth", pool="parity.lookup")
    pool = TaskPool(lambda x: [x], "parity.lookup")
    pool._queue.append(types.SimpleNamespace(timestamp=0.0, batch_size=1))
    torch_serving.SERVING_LEDGER.saturation()  # refreshes every live pool's gauges by module lookup
    assert _value(torch_registry.REGISTRY, "hivemind_moe_pool_queue_depth", pool="parity.lookup") == 1 != before


# ------------------------------------------------------------------ profiling and background tasks


def test_profiling_helpers_write_what_the_jax_package_writes(tmp_path):
    from hivemind_tpu.utils.profiling import JsonlMetricsSink as JaxJsonlMetricsSink
    from hivemind_tpu_torch.utils.profiling import JsonlMetricsSink, StepProfiler, profile_to, trace_span

    record = {"loss": 1.5, "nan": float("nan"), "inf": float("inf"), "step": 3, "name": "albert"}
    for name, sink_cls in (("jax", JaxJsonlMetricsSink), ("torch", JsonlMetricsSink)):
        sink = sink_cls(str(tmp_path / f"{name}.jsonl"))
        sink.log(record)
        sink.log({"step": 4})
        sink.close()
    assert (tmp_path / "torch.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()

    profiler = StepProfiler(flops_per_token=6.0)
    for _ in range(3):
        profiler.step(tokens=128)
    summary = profiler.summary()
    assert summary["total_tokens"] == 384 and summary["tokens_per_second"] > 0
    assert profiler.mfu(1e12) == profiler.achieved_flops / 1e12

    with profile_to(str(tmp_path / "trace")):
        with trace_span("parity.region", peer="p0"):
            torch.ones(64).add_(1)
    assert "parity.region" in (tmp_path / "trace" / "trace.json").read_text()
    assert [span.name for span in torch_tracing.RECORDER.snapshot()] == ["parity.region"]


async def test_a_failed_background_task_is_counted_by_site():
    registry = torch_registry.REGISTRY
    before = _value(registry, "hivemind_background_task_errors_total", site="parity.background")

    async def fail():
        raise RuntimeError("lost")

    task = asyncio_utils.spawn(fail(), name="parity.background")
    with pytest.raises(RuntimeError):
        await task
    await asyncio.sleep(0)  # the done-callback runs on the next loop tick
    assert _value(registry, "hivemind_background_task_errors_total", site="parity.background") - before == 1
