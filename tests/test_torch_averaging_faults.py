"""The fault matrix of ``test_allreduce_fault_tolerance.py`` on port averagers: a
faulty peer dies or stalls at each stage of the all-reduce (seeded rules of the port's
chaos engine at ``allreduce.setup`` / ``allreduce.load`` / ``allreduce.reduce``, scoped
to the faulty peer's id) or cancels its own step; the survivors must still complete,
agree on the spans surviving reducers averaged, and on at least half the vector."""

from enum import Enum, auto

import numpy as np
import pytest
import torch

from hivemind_tpu_torch.averaging import DecentralizedAverager
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.resilience import CHAOS


class Fault(Enum):
    NONE = auto()
    FAIL_BEFORE = auto()  # dies after matchmaking, before sending anything
    FAIL_SENDING = auto()  # sends the first part, then its sends abort
    SLOW_SENDING = auto()  # stalls while sending
    FAIL_REDUCING = auto()  # returns one delta, then its reduces abort
    SLOW_REDUCING = auto()  # stalls while reducing
    CANCEL = auto()  # cancels its own step right after scheduling it


def arm_fault(fault: Fault, faulty_scope: str) -> None:
    """One matrix entry as seeded chaos rules scoped to the faulty peer (every peer of
    the process shares the engine; the scope isolates the victim)."""
    CHAOS.clear()
    CHAOS.reseed(1234)
    if fault == Fault.FAIL_BEFORE:
        CHAOS.add_rule("allreduce.setup", "abort", scope=faulty_scope)
    elif fault == Fault.FAIL_SENDING:
        CHAOS.add_rule("allreduce.load", "abort", after=1, scope=faulty_scope)
    elif fault == Fault.SLOW_SENDING:
        # delay >> sender_timeout: indistinguishable from a stall to the group
        CHAOS.add_rule("allreduce.load", "delay", delay=8.0, after=1, scope=faulty_scope)
    elif fault == Fault.FAIL_REDUCING:
        CHAOS.add_rule("allreduce.reduce", "abort", after=1, scope=faulty_scope)
    elif fault == Fault.SLOW_REDUCING:
        CHAOS.add_rule("allreduce.reduce", "delay", delay=8.0, after=1, scope=faulty_scope)


def launch_swarm_of_averagers(n_peers: int, part_size_bytes: int = 64):
    first = DHT(start=True)
    maddrs = [str(m) for m in first.get_visible_maddrs()]
    dhts = [first] + [DHT(initial_peers=maddrs, start=True) for _ in range(n_peers - 1)]
    averagers = []
    for i, dht in enumerate(dhts):
        tensor = torch.from_numpy(np.random.RandomState(100 + i).randn(256).astype(np.float32))
        averagers.append(DecentralizedAverager(
            [tensor], dht, prefix="faulttest", start=True, target_group_size=n_peers,
            min_matchmaking_time=1.0, request_timeout=1.0, sender_timeout=1.5, reducer_timeout=2.0,
            part_size_bytes=part_size_bytes,  # small parts: faults hit mid-stream
        ))
    return dhts, averagers


@pytest.mark.chaos
@pytest.mark.parametrize("fault", list(Fault), ids=lambda fault: fault.name)
def test_port_allreduce_fault_tolerance(fault):
    n_peers, fault_index = 4, 1
    dhts, averagers = launch_swarm_of_averagers(n_peers)
    try:
        arm_fault(fault, faulty_scope=str(averagers[fault_index].peer_id))
        controls = [averager.step(wait=False, timeout=25, allow_retries=False) for averager in averagers]
        if fault == Fault.CANCEL:
            import time

            time.sleep(0.5)
            controls[fault_index].cancel()  # the faulty peer withdraws mid-matchmaking
        survivor_results = {}
        for i, control in enumerate(controls):
            try:
                survivor_results[i] = control.result(timeout=40)
            except Exception:
                assert i == fault_index or fault in (Fault.SLOW_SENDING, Fault.SLOW_REDUCING, Fault.CANCEL), (
                    f"healthy peer {i} failed under fault {fault.name}")
        survivors = [i for i in survivor_results if i != fault_index]
        assert len(survivors) >= n_peers - 2, f"too many casualties under {fault.name}: {survivors}"

        values = {}
        for i in survivors:
            with averagers[i].get_tensors() as tensors:
                values[i] = tensors[0].numpy().copy()
        if fault == Fault.NONE:
            for i in survivors[1:]:  # everyone holds the same average
                assert np.allclose(values[i], values[survivors[0]], atol=1e-4)
        else:
            # spans reduced by surviving reducers agree across all survivors, and at
            # least half of the vector was averaged
            agreement = np.mean([np.isclose(values[survivors[0]], values[i], atol=1e-4) for i in survivors[1:]], axis=0)
            assert agreement.mean() >= 0.5, f"{fault.name}: survivors agree on only {agreement.mean():.0%}"
        if fault not in (Fault.NONE, Fault.CANCEL):
            assert sum(CHAOS.stats().values()) >= 1, f"{fault.name}: chaos rules armed but nothing injected"
    finally:
        CHAOS.clear()
        for averager in averagers:
            averager.shutdown()
        for dht in dhts:
            dht.shutdown()


def _steps_on_the_loop(ours: DecentralizedAverager) -> list:
    """The ``_step`` tasks of ``ours`` still running on its event loop."""
    import asyncio

    async def snapshot():
        return [task for task in asyncio.all_tasks() if not task.done()
                and getattr(task.get_coro(), "__qualname__", "") == "DecentralizedAverager._step"
                and task.get_coro().cr_frame is not None and task.get_coro().cr_frame.f_locals.get("self") is ours]

    return ours._runner.run_coroutine(snapshot())


def test_shutdown_ends_a_step_that_finds_no_group():
    """An averager alone in its swarm looks for a group until its step's deadline, which
    an Optimizer's scheduled step does not set. Its shutdown must end that step: left
    running on the loop that every averager of the process shares, it went on retrying
    with jitter drawn from the process-global random stream, which the swarm simulator's
    scenarios seed and read (a whole test run's smoke scenario then lost its digest)."""
    import time

    dht = DHT(start=True)
    ours = DecentralizedAverager([torch.zeros(8)], dht, prefix="alone", start=True, target_group_size=2,
                                 min_matchmaking_time=0.5, request_timeout=0.5)
    try:
        control = ours.step(wait=False)  # no timeout: it looks until it is cancelled
        time.sleep(1.5)
        assert not control.done() and len(_steps_on_the_loop(ours)) == 1
    finally:
        ours.shutdown()
        dht.shutdown()
    deadline = time.monotonic() + 10
    while _steps_on_the_loop(ours) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _steps_on_the_loop(ours) == [] and control.done()
