#!/usr/bin/env python3
"""The swarm simulator's smoke scenario digest of one package, alone or under a disturbance.

Runs ``run_scenario("smoke", seed=11)`` (the scenario ``tests/test_torch_sim.py::
test_smoke_scenario_composite`` holds the port to the JAX package with) of the port
(``--side port``) or of the JAX package (``--side jax``) and prints its digest and
wall seconds, optionally while ``--load N`` processes spin on the host's cores, or
while ``--background-draws`` a thread of this process draws from the global
``random`` stream every millisecond (as a task left running by an earlier test in the
same process would). Both packages seed and read the process-global stream inside a
scenario, so the second moves the digest and the first should not.

    JAX_PLATFORMS=cpu python3 tools/sim_digest_probe.py --side port --load 7
    JAX_PLATFORMS=cpu python3 tools/sim_digest_probe.py --side jax --background-draws
"""

from __future__ import annotations

import argparse
import multiprocessing
import random
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _spin() -> None:
    while True:
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--side", choices=("port", "jax"), required=True)
    parser.add_argument("--load", type=int, default=0, help="processes spinning on the host's cores meanwhile")
    parser.add_argument("--background-draws", action="store_true",
                        help="a thread draws from the global random stream every millisecond meanwhile")
    args = parser.parse_args(argv)
    if args.side == "port":
        from hivemind_tpu_torch.sim import run_scenario
    else:
        from hivemind_tpu.sim import run_scenario
    spinners = [multiprocessing.Process(target=_spin, daemon=True) for _ in range(args.load)]
    for spinner in spinners:
        spinner.start()
    stop = threading.Event()

    def draw() -> None:
        while not stop.is_set():
            random.random()
            time.sleep(0.001)

    drawer = threading.Thread(target=draw, daemon=True)
    if args.background_draws:
        drawer.start()
    try:
        started = time.perf_counter()
        result = run_scenario("smoke", seed=11)
        print(f"{args.side} load={args.load} background_draws={args.background_draws}: digest {result.digest()} "
              f"in {time.perf_counter() - started:.1f} s")
    finally:
        stop.set()
        for spinner in spinners:
            spinner.terminate()
            spinner.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
