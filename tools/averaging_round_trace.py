"""A pytest plugin that records the averagers' rounds of one package, for tracing a
round that fails (a peer answering PROTOCOL_VIOLATION).

It wraps ``DecentralizedAverager`` of ``hivemind_tpu_torch`` (the default) or of
``hivemind_tpu`` (``ROUND_TRACE_PACKAGE=hivemind_tpu``) and appends one event per
step begun and ended, group registered (with its id and members), round finished or
failed, runner looked up for an incoming part (found or not, and how long the lookup
waited) and step triggered; at the end of the session it writes them to
``ROUND_TRACE_OUT`` (default ``round_trace.json``) and prints each failed lookup and
the most steps one averager had in flight at once.

Run from the repository root, e.g.:

    PYTHONPATH=tools JAX_PLATFORMS=cpu python -m pytest -p averaging_round_trace \\
        tests/test_torch_optim_modes.py::test_delayed_updates_train_two_peers
"""

from __future__ import annotations

import importlib
import json
import os
import time

EVENTS = []


def _log(*fields) -> None:
    EVENTS.append([round(time.time(), 4), *fields])


def pytest_configure(config) -> None:
    package = os.environ.get("ROUND_TRACE_PACKAGE", "hivemind_tpu_torch")
    averager = importlib.import_module(f"{package}.averaging.averager").DecentralizedAverager
    control = importlib.import_module(f"{package}.averaging.control").StepControl
    find, aggregate, step, allow = (averager._find_runner, averager._aggregate_with_group_traced, averager._step,
                                    control.allow_allreduce)

    def who(self) -> str:
        return f"{str(self.peer_id)[-6:]}/{self.prefix}"

    async def _find_runner(self, group_id, timeout=None):
        started = time.time()
        runner = await find(self, group_id, timeout)
        _log("find_runner", who(self), group_id.hex()[:8], runner is not None, round(time.time() - started, 3))
        return runner

    async def _aggregate(self, group_info, weight):
        group = group_info.group_id.hex()[:8]
        _log("register", who(self), group, [str(peer)[-6:] for peer in group_info.peer_ids])
        try:
            result = await aggregate(self, group_info, weight)
        except BaseException as e:
            _log("round_failed", who(self), group, repr(e)[:200])
            raise
        _log("round_ok", who(self), group)
        return result

    async def _step(self, step_control):
        _log("step_begin", who(self))
        try:
            return await step(self, step_control)
        finally:
            _log("step_end", who(self))

    def allow_allreduce(self):
        _log("trigger")
        return allow(self)

    averager._find_runner, averager._aggregate_with_group_traced, averager._step = _find_runner, _aggregate, _step
    control.allow_allreduce = allow_allreduce


def pytest_unconfigure(config) -> None:
    with open(os.environ.get("ROUND_TRACE_OUT", "round_trace.json"), "w") as f:
        json.dump(EVENTS, f)
    in_flight, most = {}, {}
    for event in EVENTS:
        if event[1] in ("step_begin", "step_end"):
            in_flight[event[2]] = in_flight.get(event[2], 0) + (1 if event[1] == "step_begin" else -1)
            most[event[2]] = max(most.get(event[2], 0), in_flight[event[2]])
        if event[1] == "find_runner" and not event[4]:
            print(f"[round_trace] no runner: {event}")
    print(f"[round_trace] most steps in flight per averager: {most}")
