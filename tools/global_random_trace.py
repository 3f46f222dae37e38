"""A pytest plugin that watches the process-global ``random`` stream while one test runs.

Both packages' swarm simulators seed the process-global stream at the start of a
scenario and draw from it throughout, so a draw from another thread meanwhile (a task
an earlier test left running on a shared event loop, say) moves the scenario's
digest. While the test ``GLOBAL_RANDOM_TRACE_TEST`` runs (default
``tests/test_torch_sim.py::test_smoke_scenario_composite``) this plugin records every
draw made through the ``random`` module's functions by a thread other than the main
one (its function, thread and stack), the threads alive when the test starts, and
each ``run_scenario`` call's digest of both packages; at the test's end it writes them
to ``GLOBAL_RANDOM_TRACE_OUT`` (default ``global_random_trace.json``).

Run from the repository root with the tier-1 command and these arguments added, e.g.:

    PYTHONPATH=tools JAX_PLATFORMS=cpu python -m pytest tests/ -p xdist -n 6 --dist loadfile \\
        -p global_random_trace -m 'not slow'
"""

from __future__ import annotations

import json
import os
import random
import threading
import traceback

TARGET = os.environ.get("GLOBAL_RANDOM_TRACE_TEST", "tests/test_torch_sim.py::test_smoke_scenario_composite")
FUNCTIONS = ("random", "randint", "randrange", "choice", "choices", "shuffle", "sample", "uniform", "getrandbits",
             "gauss", "expovariate")
RECORD = {"active": False, "draws": [], "threads": [], "digests": []}


def _watch(name: str, fn):
    def watched(*args, **kwargs):
        if RECORD["active"] and threading.current_thread() is not threading.main_thread():
            RECORD["draws"].append([name, threading.current_thread().name, "".join(traceback.format_stack(limit=12))])
        return fn(*args, **kwargs)

    return watched


def pytest_configure(config) -> None:
    for name in FUNCTIONS:
        setattr(random, name, _watch(name, getattr(random, name)))


def pytest_runtest_setup(item) -> None:
    if item.nodeid != TARGET:
        return
    RECORD["threads"] = [thread.name for thread in threading.enumerate()]
    for attr in ("run_scenario", "jax_run_scenario"):
        original = getattr(item.module, attr, None)
        if original is None:
            continue

        def recorded(*args, _original=original, _attr=attr, **kwargs):
            result = _original(*args, **kwargs)
            RECORD["digests"].append([_attr, result.name, result.digest()])
            return result

        setattr(item.module, attr, recorded)
    RECORD["active"] = True


def pytest_runtest_teardown(item) -> None:
    if item.nodeid != TARGET:
        return
    RECORD["active"] = False
    with open(os.environ.get("GLOBAL_RANDOM_TRACE_OUT", "global_random_trace.json"), "w") as f:
        json.dump({key: value for key, value in RECORD.items() if key != "active"}, f)
