"""PyTorch port vs JAX package: the resilience layer (retry policies, deadlines,
circuit breakers, chaos injection), on the CPU.

Both packages run the same script under the same seeds and the same fake clock;
their decisions, delays, state sequences and counters must be identical."""

import asyncio
import random
import time

import pytest

import hivemind_tpu.resilience as jax_resilience
import hivemind_tpu.telemetry.registry as jax_registry
import hivemind_tpu_torch.resilience as torch_resilience
import hivemind_tpu_torch.telemetry.registry as torch_registry
from hivemind_tpu.resilience import breaker as jax_breaker
from hivemind_tpu.resilience import chaos as jax_chaos
from hivemind_tpu_torch.resilience import breaker as torch_breaker
from hivemind_tpu_torch.resilience import chaos as torch_chaos

SIDES = {
    "jax": (jax_resilience, jax_registry.REGISTRY, jax_chaos),
    "torch": (torch_resilience, torch_registry.REGISTRY, torch_chaos),
}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    torch_resilience.CHAOS.clear()
    torch_resilience.reset_all_boards()


class FakeClock:
    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


def _value(registry, name: str, **labels) -> float:
    metric = registry.get(name)
    return 0.0 if metric is None else metric.labels(**labels).value


# ------------------------------------------------------------------ retry policy


@pytest.mark.parametrize("jitter", ["full", "equal", "none"])
def test_retry_delays_under_a_seeded_rng_match(jitter):
    delays = {}
    for side, (resilience, _registry, _chaos) in SIDES.items():
        policy = resilience.RetryPolicy(max_attempts=None, base_delay=0.05, backoff=3.0, max_delay=2.0, jitter=jitter)
        rng = random.Random(7)
        delays[side] = [policy.delay(index, rng) for index in range(8)]
    assert delays["jax"] == delays["torch"]
    assert max(delays["torch"]) <= 2.0


def test_retry_execution_sleeps_accounting_and_give_up_match():
    outcomes = {}
    for side, (resilience, registry, _chaos) in SIDES.items():
        before = _value(registry, "hivemind_resilience_retries_total", site="parity.retry")
        policy = resilience.RetryPolicy(max_attempts=4, base_delay=0.1, jitter="equal", name="parity.retry",
                                        retry_on=(ConnectionError,))
        calls, sleeps, hooks = [], [], []

        def flaky():
            calls.append(len(calls))
            if len(calls) < 3:
                raise ConnectionError(f"attempt {len(calls)}")
            return "done"

        result = policy.execute_sync(flaky, rng=random.Random(3), sleep=sleeps.append,
                                     on_retry=lambda index, exc: hooks.append((index, str(exc))))
        with pytest.raises(ConnectionError):  # gives up after max_attempts
            policy.execute_sync(lambda: (_ for _ in ()).throw(ConnectionError("down")), rng=random.Random(3),
                                sleep=sleeps.append)
        with pytest.raises(ValueError):  # not retryable: raised at once
            policy.execute_sync(lambda: (_ for _ in ()).throw(ValueError("bad")), sleep=sleeps.append)
        retries = _value(registry, "hivemind_resilience_retries_total", site="parity.retry") - before
        outcomes[side] = (result, len(calls), sleeps, hooks, retries,
                          policy.is_retryable(asyncio.CancelledError()), policy.is_retryable(ConnectionError()))
    assert outcomes["jax"] == outcomes["torch"]
    assert outcomes["torch"][4] == 2 + 3  # two retries, then three before giving up


async def test_async_retry_within_a_deadline_matches():
    outcomes = {}
    for side, (resilience, _registry, _chaos) in SIDES.items():
        policy = resilience.RetryPolicy(max_attempts=None, base_delay=0.001, backoff=1.0, jitter="none")
        attempts = []

        async def failing():
            attempts.append(1)
            raise ConnectionError("unreachable")

        deadline = resilience.Deadline(0.05)
        with pytest.raises(ConnectionError):
            await policy.execute(failing, deadline=deadline)
        expired_deadline = resilience.Deadline(0.0)
        with pytest.raises(resilience.DeadlineExceeded):
            await expired_deadline.wait_for(asyncio.sleep(1.0))
        with pytest.raises(asyncio.TimeoutError):  # DeadlineExceeded is one
            await resilience.Deadline(0.01).wait_for(asyncio.sleep(1.0))
        value = await resilience.Deadline(5.0).wait_for(asyncio.sleep(0, result="ok"), cap=1.0)
        outcomes[side] = (deadline.expired, len(attempts) > 1, value)
    assert outcomes["jax"] == outcomes["torch"] == (True, True, "ok")


@pytest.mark.parametrize("budget", [None, 0.0, 30.0])
def test_deadline_reads_match(budget):
    reads = {}
    expires_at = None if budget is None else time.monotonic() + budget
    for side, (resilience, _registry, _chaos) in SIDES.items():
        deadline = resilience.Deadline(_expires_at=expires_at) if budget is not None else resilience.Deadline.unlimited()
        remaining = deadline.remaining()
        try:
            deadline.require("the parity check")
            raised = None
        except asyncio.TimeoutError as e:
            raised = (type(e).__name__, str(e))
        reads[side] = (deadline.expired, remaining is None, remaining is not None and remaining > 29.0,
                       deadline.remaining_or(2.0) if budget != 30.0 else 2.0, raised)
    assert reads["jax"] == reads["torch"]


# ------------------------------------------------------------------ breakers

BREAKER_SCRIPT = (
    ("fail", "a"), ("fail", "a"), ("allow", "a"), ("advance", 0.5), ("fail", "a"), ("advance", 0.6),
    ("allow", "a"), ("allow", "a"), ("fail", "a"), ("advance", 1.0), ("allow", "a"), ("advance", 1.5),
    ("allow", "a"), ("success", "a"), ("fail", "b"), ("fail", "b"), ("fail", "c"), ("success", "c"),
    ("advance", 5.0), ("allow", "b"), ("advance", 2.0), ("allow", "b"), ("success", "b"), ("fail", "b"),
    ("fail", "b"),
)


def _run_breakers(resilience, clock, board_name):
    board = resilience.BreakerBoard(board_name, failure_threshold=2, recovery_time=1.0, backoff_rate=2.0,
                                    max_recovery_time=3.0, half_open_max_probes=1, clock=clock)
    trace = []
    for op, arg in BREAKER_SCRIPT:
        if op == "advance":
            clock.advance(arg)
            continue
        result = None
        if op == "fail":
            board.register_failure(arg)
        elif op == "success":
            board.register_success(arg)
        else:
            result = board.allow(arg)
        trace.append((op, arg, result, board.state(arg).value, arg in board, board.trip_count(arg),
                      sorted(board.tripped_keys())))
    trace.append(("ban_counter", dict(board.ban_counter), len(board)))
    return board, trace


def test_breaker_state_sequences_and_counters_match():
    traces, counters, states = {}, {}, {}
    for side, (resilience, registry, _chaos) in SIDES.items():
        names = ("hivemind_breaker_trips_total", "hivemind_breaker_probe_outcomes_total")
        before = [_value(registry, names[0], board="parity"),
                  _value(registry, names[1], board="parity", outcome="success"),
                  _value(registry, names[1], board="parity", outcome="failure")]
        board, traces[side] = _run_breakers(resilience, FakeClock(), "parity")
        after = [_value(registry, names[0], board="parity"),
                 _value(registry, names[1], board="parity", outcome="success"),
                 _value(registry, names[1], board="parity", outcome="failure")]
        counters[side] = [b - a for a, b in zip(before, after)] + [
            _value(registry, "hivemind_breaker_tripped", board="parity")]
        states[side] = resilience.all_board_states().get("parity")
        board.clear()
    assert traces["jax"] == traces["torch"]
    assert counters["jax"] == counters["torch"]
    assert counters["torch"][0] >= 3  # the script trips, re-trips with a longer window, and recovers
    assert states["jax"] == states["torch"] and states["torch"]["num_tripped"] >= 1


@pytest.mark.parametrize("side_module", [jax_breaker, torch_breaker], ids=["jax", "torch"])
def test_breaker_lru_keeps_tripped_keys(side_module):
    """The board's cap drops healthy keys first, in both packages."""
    clock = FakeClock()
    board = side_module.BreakerBoard("parity.lru", maxsize=3, failure_threshold=2, clock=clock)
    board.register_failure("tripped")
    board.register_failure("tripped")
    for key in ("x", "y", "z", "w"):  # one failure each: tracked, not tripped
        board.register_failure(key)
    assert board.tripped_keys() == ["tripped"] and len(board) == 3
    board.clear()


# ------------------------------------------------------------------ chaos

CHAOS_SPEC = ("seed=11;moe.forward:drop:prob=0.4:scope=expert.1;moe.*:corrupt_payload:prob=0.5:after=2:times=6;"
              "p2p.unary.send:abort:prob=0.3;allreduce.load:throttle:rate=1e12;"
              "p2p.stream.recv:drop:scope=link:QmA*->QmB*;dht.rpc_find:delay:delay=0:prob=0.5")
CHAOS_CALLS = [
    ("moe.forward", "expert.1", b"\x01" * 300), ("moe.forward", "expert.2", b"\x02" * 40),
    ("moe.backward", "expert.1", b"\x03" * 600), ("p2p.unary.send", "QmA", None),
    ("allreduce.load", "QmA", b"\x04" * 64), ("p2p.stream.recv", "link:QmAlice->QmBob", b"\x05"),
    ("p2p.stream.recv", "link:QmBob->QmAlice", b"\x06"), ("dht.rpc_find", None, None),
]


async def _drive_chaos(engine, rounds: int = 12):
    outcomes = []
    for _ in range(rounds):
        for point, scope, payload in CHAOS_CALLS:
            try:
                result = await engine.inject(point, payload=payload, scope=scope)
                outcomes.append(("ok", point, result))
            except Exception as e:
                outcomes.append((type(e).__name__, point, str(e)))
    return outcomes


async def test_chaos_spec_parsing_decisions_and_counters_match():
    results = {}
    for side, (_resilience, registry, chaos) in SIDES.items():
        engine = chaos.ChaosEngine()
        engine.configure_from_env({"HIVEMIND_CHAOS": CHAOS_SPEC})
        rules = [(r.point, r.action, r.prob, r.delay, r.rate, r.after, r.times, r.scope) for r in engine.rules]
        keys = sorted({(point, rule[1]) for rule in rules for point, _scope, _payload in CHAOS_CALLS})
        before = {key: _value(registry, "hivemind_chaos_injections_total", point=key[0], action=key[1]) for key in keys}
        outcomes = await _drive_chaos(engine)
        injected = {key: _value(registry, "hivemind_chaos_injections_total", point=key[0], action=key[1]) - before[key]
                    for key in keys}
        engine.reseed(11)
        replay = await _drive_chaos(engine)
        results[side] = (rules, outcomes, engine.stats(), injected, replay == outcomes)
    assert results["jax"] == results["torch"]
    rules, outcomes, stats, injected, replayed = results["torch"]
    assert len(rules) == 6 and replayed
    kinds = {outcome[0] for outcome in outcomes}
    assert {"ok", "ChaosDrop", "ChaosAbort"} <= kinds
    assert sum(injected.values()) == sum(stats.values()) > 0
    # a link rule fires on its direction only
    assert ("ChaosDrop", "p2p.stream.recv", "chaos: dropped at p2p.stream.recv") in outcomes
    assert all(outcome[0] == "ok" for outcome in outcomes[6::len(CHAOS_CALLS)])


@pytest.mark.parametrize("spec", ["moe.forward", "moe.forward:drop:bogus=1", "moe.forward:drop:prob=x"])
def test_chaos_rejects_the_same_bad_specs(spec):
    errors = {}
    for side, (_resilience, _registry, chaos) in SIDES.items():
        with pytest.raises(ValueError) as error:
            chaos.ChaosEngine().configure(spec)
        errors[side] = str(error.value)
    assert errors["jax"] == errors["torch"]


def test_chaos_catalog_and_process_engine_match():
    assert torch_chaos.INJECTION_POINTS == jax_chaos.INJECTION_POINTS
    assert torch_chaos.ACTIONS == jax_chaos.ACTIONS
    assert issubclass(torch_chaos.ChaosDrop, ConnectionError) and issubclass(torch_chaos.ChaosAbort, RuntimeError)
    assert not torch_resilience.CHAOS.enabled  # HIVEMIND_CHAOS is unset in the test environment
    assert torch_chaos._rule_seed(3, 1, "moe.forward", "drop") == jax_chaos._rule_seed(3, 1, "moe.forward", "drop")
