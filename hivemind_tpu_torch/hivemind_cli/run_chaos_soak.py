"""Chaos soak (the port of hivemind_tpu/hivemind_cli/run_chaos_soak.py): a small in-process
swarm trains under a seeded fault schedule covering every named injection
point, then the faults stop and the soak asserts the swarm LIVED through it:

- every peer's optimizer step count (and epoch) keeps advancing,
- the MoE client keeps getting expert responses after the faults stop,
- every circuit breaker tripped during the storm returns to closed,
- every named injection point actually saw traffic,
- the round ledger NAMED at least one straggler during the chaos-delay phase
  (injected slowness must be attributable, not just survivable), and
  the event-loop watchdog counted zero stalls once the faults were disarmed,
- with ``--churn``: peers are crash-killed on a seeded schedule (their DHT
  yanked mid-round, no shutdown, state declarations left dangling) and
  restarted with a local checkpoint directory — the verdict then requires
  ``state_recovered: true`` (every restarted peer back at the tracker's global
  epoch via digest-verified state) and ``digest_failures_adopted: 0`` (chaos
  corrupted payloads on ``state.download.*``, and not one unverified tensor
  was ever adopted).

The trainers' toy parameters and the MoE servers' ``ffn`` experts live on
``device`` (``cuda`` unless the caller asks for the CPU): the toy loss is a torch
autograd loss there, the Optimizer runs the port's ``optim.transforms.sgd``.

Run it::

    python -m hivemind_tpu_torch.hivemind_cli.run_chaos_soak --peers 4 --duration 60
    python -m hivemind_tpu_torch.hivemind_cli.run_chaos_soak --peers 4 --duration 60 --churn
    python -m hivemind_tpu_torch.hivemind_cli.run_chaos_soak --device cpu --duration 18

or programmatically via :func:`run_soak` (the chaos-marked tests use a short
configuration of the same function). The schedule is deterministic per seed —
a failing soak replays exactly with the same ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from hivemind_tpu_torch.hivemind_cli.run_blackbox import reconstruct_final_round
from hivemind_tpu_torch.resilience import CHAOS, INJECTION_POINTS, reset_all_boards
from hivemind_tpu_torch.telemetry import REGISTRY
from hivemind_tpu_torch.telemetry.blackbox import BlackBox, read_spool
from hivemind_tpu_torch.telemetry.device import (
    arm_device_telemetry,
    device_snapshot,
    disarm_device_telemetry,
)
from hivemind_tpu_torch.telemetry.ledger import LEDGER
from hivemind_tpu_torch.telemetry.tracing import RECORDER, thread_current_span
from hivemind_tpu_torch.telemetry.watchdog import watchdog_summary
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# faults are proportionate, not apocalyptic: the paper's claim is surviving an
# UNRELIABLE swarm, not a dead one — each point sees regular drops/delays/aborts
DEFAULT_SCHEDULE = (
    ("p2p.unary.send", "drop", dict(prob=0.04)),
    ("p2p.unary.recv", "delay", dict(prob=0.05, delay=0.15)),
    ("p2p.stream.send", "delay", dict(prob=0.03, delay=0.1)),
    ("p2p.stream.recv", "drop", dict(prob=0.01)),
    ("dht.rpc_ping", "drop", dict(prob=0.1)),
    ("dht.rpc_store", "drop", dict(prob=0.15)),
    ("dht.rpc_find", "drop", dict(prob=0.15)),
    ("allreduce.setup", "abort", dict(prob=0.05)),
    ("allreduce.load", "delay", dict(prob=0.05, delay=0.25)),
    ("allreduce.reduce", "abort", dict(prob=0.02)),
    ("moe.forward", "drop", dict(prob=0.25)),
    ("moe.backward", "drop", dict(prob=0.25)),
    # the recovery path under fire: corrupted donor payloads must be
    # caught by digest verification, dropped streams must resume via failover
    ("state.download.send", "corrupt_payload", dict(prob=0.2)),
    ("state.download.recv", "drop", dict(prob=0.1)),
)


def arm_default_schedule(seed: int) -> None:
    CHAOS.clear()
    CHAOS.reseed(seed)
    for point, action, kwargs in DEFAULT_SCHEDULE:
        CHAOS.add_rule(point, action, **kwargs)


def _toy_problem(seed: int = 0, device: str = "cuda"):
    """A least-squares regression on ``device``: its features, targets, and a loss
    returning ``(loss, {"w": gradient})`` for parameters ``{"w": tensor}``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    true_w = rng.randn(8).astype(np.float32)
    features = rng.randn(256, 8).astype(np.float32)
    targets = features @ true_w
    features_t, targets_t = torch.from_numpy(features).to(device), torch.from_numpy(targets).to(device)

    def loss_and_grad(params, batch):
        w = params["w"].detach().requires_grad_(True)
        x, y = features_t[batch], targets_t[batch]
        loss = torch.mean((x @ w - y) ** 2)
        (grad,) = torch.autograd.grad(loss, [w])
        return loss, {"w": grad}

    return features, targets, loss_and_grad


def run_soak(
    n_peers: int = 4,
    duration: float = 60.0,
    seed: int = 0,
    chaos_fraction: float = 0.6,
    include_moe: bool = True,
    spec: Optional[str] = None,
    churn: bool = False,
    churn_kills: Optional[int] = None,
    checkpoint_root: Optional[str] = None,
    blackbox_root: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Run the soak; returns a JSON-able report with an ``ok`` verdict. ``device``
    holds every trainer's parameters and the MoE server's experts (``"cuda"``
    unless the caller asks for the CPU; without a card the default raises).

    With ``churn=True``, ``churn_kills`` peers (default ``max(1, n_peers // 3)``;
    never peer 0, which anchors the DHT bootstrap and the download prober) are
    crash-killed on a seeded schedule inside the chaos window and restarted a few
    seconds later with the same local checkpoint directory.

    Every peer writes a black-box spool under ``blackbox_root`` (
    defaults to a tempdir when churn is on). A churn kill abandons the
    victim's spool exactly as a kill-9 would — active segment unpublished,
    torn tail and all — and the verdict then also requires
    ``postmortem_reconstructed``: the victim's final round and its last
    in-flight span rebuilt from that spool by the ``hivemind-blackbox``
    machinery.
    """
    import random as random_module

    import numpy as np
    import torch

    from hivemind_tpu_torch.averaging.state_sync import (
        _STATE_SYNC_DIGEST_FAILURES,
        _STATE_SYNC_UNVERIFIED,
    )
    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS
    from hivemind_tpu_torch.optim import Optimizer, transforms
    from hivemind_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    report: Dict[str, object] = {
        "n_peers": n_peers, "duration": duration, "seed": seed, "churn": churn, "runs_on": device, "errors": [],
    }
    reset_all_boards()
    # arm the flight recorder for THIS soak: a fresh ring means every chaos
    # span event found at verdict time was injected by this run (the
    # chaos engine and the tracer must provably connect)
    RECORDER.clear()
    # same for the round ledger: every record + straggler attribution
    # found at verdict time was produced under this soak's rounds
    LEDGER.clear()
    # device-side observability: compile/memory events spool into
    # every peer's black box, so a victim's corpse carries its last device state
    arm_device_telemetry()

    def _total_watchdog_stalls() -> float:
        metric = REGISTRY.get("hivemind_event_loop_stalls_total")
        return sum(child.value for _key, child in metric.series()) if metric is not None else 0.0
    digest_failures_before = _STATE_SYNC_DIGEST_FAILURES.value(site="download")
    unverified_before = _STATE_SYNC_UNVERIFIED.value()
    # the soak's recovery window is short: expert breakers must be probeable
    # within it (the production default is restored in the outer finally)
    original_expert_recovery = EXPERT_BREAKERS._kwargs["recovery_time"]
    EXPERT_BREAKERS.reconfigure(recovery_time=4.0)

    # ------------------------------------------------------------ swarm
    first = DHT(start=True)
    maddrs = [str(m) for m in first.get_visible_maddrs()]
    dhts: List[DHT] = [first] + [DHT(initial_peers=maddrs, start=True) for _ in range(n_peers - 1)]

    checkpoint_dir_ctx = None
    if churn and checkpoint_root is None:
        checkpoint_dir_ctx = tempfile.TemporaryDirectory(prefix="chaos_soak_ckpt_")
        checkpoint_root = checkpoint_dir_ctx.name
    blackbox_dir_ctx = None
    if churn and blackbox_root is None:
        blackbox_dir_ctx = tempfile.TemporaryDirectory(prefix="chaos_soak_blackbox_")
        blackbox_root = blackbox_dir_ctx.name

    server = None
    moe_stats = {"ok_during": 0, "ok_after": 0, "calls": 0}
    stop_event = threading.Event()
    chaos_off_event = threading.Event()
    errors: List[str] = []
    step_counts: Dict[int, int] = {index: 0 for index in range(n_peers)}
    epochs: Dict[int, int] = {index: 0 for index in range(n_peers)}

    class _TrainerSlot:
        def __init__(self, index: int, dht: DHT, restarts: int = 0):
            self.index = index
            self.dht = dht
            self.kill = threading.Event()  # crash simulation: NO clean shutdown
            self.opt = None
            self.thread: Optional[threading.Thread] = None
            self.restarts = restarts
            self.box: Optional[BlackBox] = None
            self.spool_dir: Optional[str] = None
            if blackbox_root is not None:
                # one spool per peer INCARNATION: a restart writes a fresh
                # directory, so the dead incarnation's spool stays exactly as
                # the crash left it (the post-mortem's evidence)
                suffix = f"-r{restarts}" if restarts else ""
                self.spool_dir = f"{blackbox_root}/peer{index}{suffix}"
                self.box = BlackBox(
                    self.spool_dir, peer=f"peer{index}", peer_filter=str(dht.peer_id)
                )

    slots: Dict[int, _TrainerSlot] = {index: _TrainerSlot(index, dht) for index, dht in enumerate(dhts)}
    dead_peer_ids: List[str] = []  # breakers for these ids legitimately stay open
    retired_threads: List[threading.Thread] = []  # crash-killed trainers, still joined at exit
    victim_spools: List[Dict[str, object]] = []  # abandoned spool dirs, one per kill

    features, targets, loss_and_grad = _toy_problem(seed, device)

    def run_trainer(slot: _TrainerSlot) -> None:
        try:
            opt = Optimizer(
                dht=slot.dht, run_id="chaos_soak", target_batch_size=64,
                params={"w": torch.zeros(8, dtype=torch.float32, device=device)}, optimizer=transforms.sgd(0.2),
                batch_size_per_step=16, matchmaking_time=1.5, averaging_timeout=20,
                average_state_every=1, target_group_size=2, verbose=False,
                load_state_timeout=15,
                checkpoint_dir=(
                    f"{checkpoint_root}/peer{slot.index}" if checkpoint_root is not None else None
                ),
                tracker_opts=dict(min_refresh_period=0.3, default_refresh_period=0.5),
            )
            slot.opt = opt
            rng_local = np.random.RandomState(slot.index + 101 * slot.restarts)
            while not stop_event.is_set() and not slot.kill.is_set():
                batch = rng_local.choice(len(features), 16)
                _loss, grads = loss_and_grad(opt.params, torch.from_numpy(batch).to(device))
                opt.step(grads)
                step_counts[slot.index] += 1
                epochs[slot.index] = opt.local_epoch
                time.sleep(0.25)
            if slot.kill.is_set():
                return  # kill -9 semantics: no opt.shutdown(), declarations left dangling
            opt.shutdown()
        except Exception as e:
            if slot.kill.is_set():
                return  # expected: the DHT was yanked out from under a live step
            errors.append(f"trainer {slot.index}: {e!r}")

    def run_moe_client(client_dht: DHT, expert_uids) -> None:
        from hivemind_tpu_torch.moe import RemoteExpert, get_experts
        from hivemind_tpu_torch.moe.client.call_many import RemoteCallMany

        try:
            infos = get_experts(client_dht, list(expert_uids))
            experts = [RemoteExpert(info, client_dht.node.p2p) for info in infos if info is not None]
            if not experts:
                errors.append("moe client: no experts resolved")
                return
            x = np.random.RandomState(seed).randn(2, 16).astype(np.float32)
            while not stop_event.is_set():
                moe_stats["calls"] += 1
                try:
                    rcm = RemoteCallMany([experts], k_min=0, forward_timeout=10.0)
                    outputs, alive = rcm._forward_np(x)
                    if np.asarray(alive).any():
                        key = "ok_after" if chaos_off_event.is_set() else "ok_during"
                        moe_stats[key] += 1
                        grad = np.ones_like(outputs)
                        rcm._backward_np(x, grad, alive)
                except Exception as e:
                    logger.debug(f"moe soak call failed: {e!r}")
                time.sleep(0.5)
        except Exception as e:
            errors.append(f"moe client: {e!r}")

    def run_pinger() -> None:
        """Steady-state swarms barely ping (it is a bootstrap/staleness RPC): a
        light probe loop keeps the dht.rpc_ping injection point exercised."""

        async def ping_one_neighbor(_dht, node):
            contacts = list(node.protocol.routing_table.iter_nodes())
            if contacts:
                await node.protocol.call_ping(contacts[0][1].peer_id)

        while not stop_event.is_set():
            for slot in slots.values():
                if slot.kill.is_set():
                    continue
                try:
                    slot.dht.run_coroutine(ping_one_neighbor)
                except Exception as e:
                    logger.debug(f"soak pinger: {e!r}")
            time.sleep(1.0)

    def run_downloader() -> None:
        """Periodic verified state downloads keep the state.download.* injection
        points exercised even before any peer falls behind: the prober pulls the
        trainers' shared state exactly the way a joining peer would."""
        from hivemind_tpu_torch.averaging.averager import DecentralizedAverager

        async def _probe(_dht, _node):
            p2p = await _dht.replicate_p2p()
            return await DecentralizedAverager._download_verified_async(
                _dht, p2p, "chaos_soak_state", exclude_peer_id=_dht.peer_id, timeout=6.0
            )

        while not stop_event.is_set():
            slot = slots[0]  # never churn-killed: its DHT outlives the soak
            try:
                slot.dht.run_coroutine(_probe)
            except Exception as e:
                logger.debug(f"soak downloader: {e!r}")
            for _ in range(4):
                if stop_event.is_set():
                    return
                time.sleep(0.5)

    def _spawn_joined_dht(rng) -> Optional[DHT]:
        """A fresh DHT that actually JOINED the swarm: with chaos dropping DHT
        RPCs, a single bootstrap attempt can fail silently and leave the node
        isolated forever (empty routing table) — a rebooted machine would retry
        its bootstrap too, so the churn restart does."""

        async def _table_size(_dht, node):
            return len(list(node.protocol.routing_table.iter_nodes()))

        for _attempt in range(6):
            candidate = None
            try:
                # construction itself throws when chaos eats the bootstrap pings
                candidate = DHT(initial_peers=maddrs, start=True)
                if candidate.run_coroutine(_table_size) > 0:
                    return candidate
            except Exception as e:
                logger.debug(f"churn bootstrap attempt failed: {e!r}")
            if candidate is not None:
                candidate.shutdown()
            if stop_event.wait(rng.uniform(0.5, 1.5)):
                return None
        return None

    def run_churn(chaos_window: float) -> None:
        """Seeded kill/restart schedule: each kill yanks the victim's DHT with no
        shutdown (mid-round, possibly mid-download for its downloaders), then
        restarts the peer on a fresh DHT with the same checkpoint directory."""
        rng = random_module.Random(seed + 0xC0FFEE)
        kills = churn_kills if churn_kills is not None else max(1, n_peers // 3)
        kill_times = sorted(rng.uniform(0.25, 0.7) * chaos_window for _ in range(kills))
        start = time.monotonic()
        # peer 0 anchors the DHT bootstrap + download prober; the last peer's DHT
        # is the MoE client's transport — killing it would orphan the client's
        # RemoteExperts for the rest of the soak and fail moe_recovered
        last_victim = n_peers - 1 if include_moe else n_peers
        victims = [index for index in range(1, last_victim)]
        if not victims:
            errors.append("churn: no eligible victims (need more peers for this configuration)")
            return
        for kill_time in kill_times:
            delay = start + kill_time - time.monotonic()
            if delay > 0:
                if stop_event.wait(delay):
                    return
            candidates = [i for i in victims if not slots[i].kill.is_set()]
            # quorum counts LIVE slots (restarted peers are alive again) — the
            # cumulative dead_peer_ids list exists for breaker bookkeeping only
            live = sum(1 for slot in slots.values() if not slot.kill.is_set())
            if len(candidates) < 1 or live <= 2:
                continue  # keep a quorum able to form groups
            index = rng.choice(candidates)
            slot = slots[index]
            # die MID-OPERATION when possible: wait (bounded) until the victim's
            # trainer thread has a span open, so the abandoned spool holds a
            # span_start with no finish — the post-mortem's "died inside this
            # operation" evidence (a real crash overwhelmingly lands mid-step;
            # the 0.25 s inter-step sleep is the only quiet window)
            mid_span_deadline = time.monotonic() + 5.0
            while (
                time.monotonic() < mid_span_deadline
                and not stop_event.is_set()
                and (slot.thread is None or thread_current_span(slot.thread.ident) is None)
            ):
                time.sleep(0.05)
            logger.warning(f"churn: crash-killing trainer {index}")
            slot.kill.set()
            victim_peer_id = None
            try:
                victim_peer_id = str(slot.dht.peer_id)  # unreadable once shut down
                dead_peer_ids.append(victim_peer_id)
                slot.dht.shutdown()  # the "power cord": transport dies instantly
            except Exception as e:
                logger.debug(f"churn kill {index}: {e!r}")
            if slot.box is not None:
                # kill-9 the spool too: unsubscribe without publishing — the
                # .open segment stays on disk exactly as the dead peer left it
                slot.box.abandon()
                victim_spools.append(
                    {"index": index, "dir": slot.spool_dir, "peer_id": victim_peer_id}
                )
            if stop_event.wait(rng.uniform(2.0, 4.0)):
                return
            logger.warning(f"churn: restarting trainer {index}")
            try:
                new_dht = _spawn_joined_dht(rng)
            except Exception as e:
                errors.append(f"churn restart {index}: {e!r}")
                continue
            if new_dht is None:
                if not stop_event.is_set():
                    errors.append(f"churn restart {index}: could not rejoin the swarm")
                continue
            new_slot = _TrainerSlot(index, new_dht, restarts=slot.restarts + 1)
            if slot.thread is not None:
                retired_threads.append(slot.thread)
            slots[index] = new_slot
            new_slot.thread = threading.Thread(target=run_trainer, args=(new_slot,))
            new_slot.thread.start()

    threads: List[threading.Thread] = []
    try:
        try:
            if include_moe:
                from hivemind_tpu_torch.moe import Server

                expert_uids = ("soak_expert.0", "soak_expert.1")
                server = Server.create(
                    expert_uids=list(expert_uids), expert_cls="ffn", hidden_dim=16,
                    dht=dhts[0], start=True, max_batch_size=64,
                    optim_factory=lambda params: torch.optim.SGD(params, lr=1e-3), device=device,
                )
                time.sleep(1.0)  # let the experts land in the DHT
                threads.append(threading.Thread(target=run_moe_client, args=(dhts[-1], expert_uids)))

            threads.append(threading.Thread(target=run_pinger))
            threads.append(threading.Thread(target=run_downloader))
            for slot in slots.values():
                slot.thread = threading.Thread(target=run_trainer, args=(slot,))
            trainer_threads_initial = [slots[index].thread for index in range(n_peers)]
            for thread in threads + trainer_threads_initial:
                thread.start()

            # phase 1: faults armed (and, with --churn, peers dying)
            if spec:
                CHAOS.configure(spec, seed=seed)
            else:
                arm_default_schedule(seed)
            chaos_window = duration * chaos_fraction
            churn_thread = None
            if churn:
                churn_thread = threading.Thread(target=run_churn, args=(chaos_window,))
                churn_thread.start()
            time.sleep(chaos_window)
            steps_at_chaos_end = dict(step_counts)
            report["chaos_stats"] = CHAOS.stats()
            points_exercised = {rule.point for rule in CHAOS.rules if rule.calls > 0}
            # count injected faults visible in the trace NOW, before the
            # recovery phase's spans can evict the chaos-era ones from the ring
            chaos_span_events = sum(
                sum(1 for _t, name, _a in span.events or () if name.startswith("chaos."))
                for span in RECORDER.snapshot()
            )
            report["chaos_span_events"] = chaos_span_events
            # ledger verdict inputs, read NOW while every record is chaos-era
            #: the chaos-delay schedule must have produced at least
            # one straggler attribution — a partner named slowest in a record
            # AND actually slow. The slowness floor keeps the check from being
            # vacuous: every round with a remote exchange names SOME slowest
            # peer, so bare existence would pass even with no delay rule armed.
            # 0.1 s is the smallest delay in DEFAULT_SCHEDULE, ~2x a healthy
            # toy-round exchange on this swarm.
            chaos_ledger_records = LEDGER.records()
            report["ledger_rounds_under_chaos"] = len(chaos_ledger_records)
            straggler_floor_s = 0.1
            report["straggler_attributions_under_chaos"] = sum(
                1 for record in chaos_ledger_records
                if record.get("slowest_peer")
                and float(record.get("slowest_s", 0.0)) >= straggler_floor_s
            )
            CHAOS.clear()
            chaos_off_event.set()
            # the disarmed-phase watchdog baseline: any stall counted from here
            # on happened with NO faults armed — a real bug, not injected noise
            stalls_at_disarm = _total_watchdog_stalls()
            logger.warning("chaos window over: faults disarmed, watching recovery")

            # phase 2: recovery. The base window is fixed; with churn, a BOUNDED
            # extra wait runs only while a restarted peer still lags the swarm —
            # on a loaded 1-core CI box, averaging rounds stretch to their full
            # timeouts and a fixed window flakes on liveness the peer is already
            # in the middle of demonstrating
            time.sleep(duration - chaos_window)
            if churn_thread is not None:
                churn_thread.join(timeout=60)

            def _swarm_global_epoch() -> int:
                best = 0
                for slot in slots.values():
                    if slot.opt is not None and not slot.kill.is_set():
                        try:
                            best = max(best, slot.opt.tracker.global_epoch)
                        except Exception:
                            continue
                return best

            def _lagging_restarts() -> List[int]:
                # the SAME swarm-wide view the verdict uses — a restarted peer's
                # own tracker can lag the survivors' by an epoch under load, and
                # waiting on the wrong view flakes the verdict
                global_now = _swarm_global_epoch()
                return [
                    index for index, slot in slots.items()
                    if slot.restarts > 0
                    and (slot.opt is None or slot.opt.local_epoch < global_now - 1)
                ]

            if churn:
                extra_deadline = time.monotonic() + max(30.0, duration - chaos_window)
                while time.monotonic() < extra_deadline and _lagging_restarts():
                    time.sleep(1.0)

            # final swarm view BEFORE teardown: the restarted peers' verdict is
            # measured against the tracker's global epoch, not a local guess
            final_global_epoch = _swarm_global_epoch()
            # where the trainers' parameters and the experts actually live
            report["placement"] = {
                "trainers": sorted({str(slot.opt.params["w"].device) for slot in slots.values()
                                    if slot.opt is not None}),
                "experts": sorted({str(backend.device) for backend in server.backends.values()})
                if server is not None else [],
            }
        finally:
            stop_event.set()
            live_threads = [slot.thread for slot in slots.values() if slot.thread is not None]
            for thread in threads + live_threads + retired_threads:
                thread.join(timeout=60)
            if server is not None:
                server.shutdown()
            for slot in slots.values():
                if slot.box is not None:
                    slot.box.close()  # survivors publish cleanly; victims were abandoned
                if not slot.kill.is_set():
                    slot.dht.shutdown()

        # ------------------------------------------------------------ verdict
        tripped = {}
        for index, slot in slots.items():
            if slot.kill.is_set():
                continue
            try:
                blacklist = slot.dht.node.blacklist
            except Exception:
                continue
            open_keys = [str(key) for key in blacklist.tripped_keys()]
            # a breaker held open against a peer we crash-killed (and whose old
            # identity never came back) is the breaker WORKING, not a failure
            open_keys = [key for key in open_keys if key not in dead_peer_ids]
            tripped[f"dht_blacklist[{index}]"] = open_keys
        tripped["moe_expert"] = [str(key) for key in EXPERT_BREAKERS.tripped_keys()]

        total_injections = sum(report.get("chaos_stats", {}).values())
        missed_points = sorted(
            point for point in INJECTION_POINTS
            if point not in points_exercised
            and (include_moe or not point.startswith("moe."))
        )
        steps_after_chaos = {
            index: step_counts[index] - steps_at_chaos_end.get(index, 0) for index in step_counts
        }

        restarted = {index: slot for index, slot in slots.items() if slot.restarts > 0}
        restart_report = {}
        for index, slot in restarted.items():
            # read the LIVE optimizer, not the per-step snapshot: a peer deep in
            # a slow averaging round has advanced past its last-reported epoch
            local_epoch = slot.opt.local_epoch if slot.opt is not None else 0
            restart_report[index] = {
                "restarts": slot.restarts,
                "final_epoch": local_epoch,
                "global_epoch": final_global_epoch,
                # one-epoch grace is inherent to the protocol: a peer at
                # global-1 transitions itself on its next ready step
                "recovered": local_epoch >= final_global_epoch - 1 and local_epoch > 0,
            }
        digest_failures = _STATE_SYNC_DIGEST_FAILURES.value(site="download") - digest_failures_before
        digest_failures_adopted = _STATE_SYNC_UNVERIFIED.value() - unverified_before
        stalls_while_disarmed = _total_watchdog_stalls() - stalls_at_disarm
        report["watchdog"] = watchdog_summary()
        report["watchdog_stalls_while_disarmed"] = stalls_while_disarmed
        report["ledger_summary"] = LEDGER.summary()
        report["device"] = device_snapshot()

        # post-mortem: every kill -9'd victim left an unpublished
        # ``.open`` spool behind; rebuild its final round from the corpse with
        # the same reader hivemind-blackbox uses. Reconstruction must name the
        # span the victim died inside — a spool that only shows cleanly
        # finished work means the recorder was not crash-durable.
        postmortems: Dict[str, Dict[str, object]] = {}
        for entry in victim_spools:
            spool_dir = str(entry["dir"])
            try:
                frames, spool_stats = read_spool(spool_dir)
                post = reconstruct_final_round(frames, spool_stats)
            except Exception as exc:  # a corrupt corpse is a finding, not a crash
                postmortems[spool_dir] = {"error": repr(exc), "reconstructed": False}
                continue
            final_round = post.get("final_round") or {}
            in_flight = post.get("last_in_flight") or {}
            device_frames = sum(1 for frame in frames if frame.get("k") == "device")
            postmortems[spool_dir] = {
                "peer": f"peer{entry['index']}",
                "frames": spool_stats.get("frames", 0),
                "device_frames": device_frames,
                "torn_tail": spool_stats.get("torn_tail", 0),
                "corrupt": spool_stats.get("corrupt", 0),
                "final_round": final_round.get("round"),
                "final_round_slowest": final_round.get("slowest_peer"),
                "last_in_flight_span": in_flight.get("name"),
                "open_spans": post.get("open_spans", 0),
                "reconstructed": bool(post.get("reconstructed"))
                and in_flight.get("name") is not None,
            }
        report["postmortems"] = postmortems
        if blackbox_root is not None:
            report["blackbox_root"] = blackbox_root

        report.update(
            steps=dict(step_counts),
            steps_after_chaos=steps_after_chaos,
            epochs=dict(epochs),
            moe=dict(moe_stats),
            breakers_still_tripped={name: keys for name, keys in tripped.items() if keys},
            missed_points=missed_points,
            total_injections=total_injections,
            digest_failures=digest_failures,
            digest_failures_adopted=digest_failures_adopted,
            restarts=restart_report,
            state_recovered=all(entry["recovered"] for entry in restart_report.values()),
            errors=errors,
        )

        checks = {
            "steps_advanced": all(count > 0 for count in step_counts.values()),
            "steps_advanced_after_chaos": all(count > 0 for count in steps_after_chaos.values()),
            "breakers_recovered": not report["breakers_still_tripped"],
            "every_point_exercised": not missed_points,
            "faults_injected": total_injections >= 10,
            # the loop between the chaos engine and the flight recorder: at
            # least one injected fault must be visible as a span event
            "chaos_visible_in_trace": report.get("chaos_span_events", 0) >= 1,
            # corrupted payloads may be REJECTED (digest_failures > 0 is
            # expected under the corrupt_payload rule) but never ADOPTED
            "digest_failures_adopted_zero": digest_failures_adopted == 0,
            # attribution verdict: the chaos-delay phase must have
            # NAMED a slow partner in the round ledger...
            "straggler_attributed": report["straggler_attributions_under_chaos"] >= 1,
            # ...and a healthy, undisturbed swarm must not stall its loops —
            # a disarmed-phase stall is a real blocking bug the faults masked
            "watchdog_stalls_zero_disarmed": stalls_while_disarmed == 0,
            "no_thread_errors": not errors,
        }
        if include_moe:
            checks["moe_recovered"] = moe_stats["ok_after"] > 0
        if churn:
            checks["peers_restarted"] = bool(restart_report)
            checks["state_recovered"] = bool(report["state_recovered"]) and bool(restart_report)
            # the flight-recorder loop closed: at least one victim's final
            # round AND its dying in-flight span came back out of the spool
            checks["postmortem_reconstructed"] = bool(postmortems) and any(
                entry.get("reconstructed") for entry in postmortems.values()
            )
            # device telemetry is crash-durable too: at least one
            # victim's corpse must carry compile/memory frames
            checks["device_frames_in_victim_spool"] = bool(postmortems) and any(
                entry.get("device_frames", 0) > 0 for entry in postmortems.values()
            )
        report["checks"] = checks
        report["ok"] = all(checks.values())
        return report
    finally:
        # ALWAYS disarm and restore, even when setup or teardown raised: armed
        # chaos rules or a 4 s expert recovery window leaking past run_soak
        # would silently distort everything that runs later in the process
        CHAOS.clear()
        EXPERT_BREAKERS.reconfigure(recovery_time=original_expert_recovery)
        reset_all_boards()
        disarm_device_telemetry()
        if checkpoint_dir_ctx is not None:
            checkpoint_dir_ctx.cleanup()
        if blackbox_dir_ctx is not None:
            blackbox_dir_ctx.cleanup()


def run_serving_churn(
    duration: float = 45.0,
    seed: int = 0,
    n_experts: int = 2,
    stall_fraction: float = 0.25,
    kill_fraction: float = 0.45,
    restart_fraction: float = 0.7,
    device: str = "cuda",
) -> dict:
    """Serving-churn soak: two servers replicate the same expert
    grid; mid-traffic one replica is first STALLED (its runtime suspended — the
    straggler that makes hedges fire) and then crash-killed (its DHT yanked, no
    shutdown), later restarted under a fresh identity. The verdict requires:

    - ``hedges_fired >= 1`` — the stall was hedged around, not waited out,
    - ``client_failures == 0`` — replica death is never client-visible
      (failover + hedging absorb it),
    - ``breakers_recovered`` — after the restart, no breaker is left open
      except against the dead identity (which never comes back),
    - ``post_restart_ok > 0`` and the resolved replica set includes the
      restarted server.
    """
    import torch

    from hivemind_tpu_torch.dht import DHT
    from hivemind_tpu_torch.moe import RemoteExpert, Server, get_experts
    from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS
    from hivemind_tpu_torch.telemetry.serving import SCORECARDS

    report: Dict[str, object] = {"duration": duration, "seed": seed, "mode": "serving_churn", "runs_on": device}
    sgd = lambda params: torch.optim.SGD(params, lr=1e-3)
    reset_all_boards()
    SCORECARDS.clear()
    original_recovery = EXPERT_BREAKERS._kwargs["recovery_time"]
    EXPERT_BREAKERS.reconfigure(recovery_time=3.0)
    uids = [f"srv_churn.{i}" for i in range(n_experts)]

    def hedge_counts() -> Dict[str, float]:
        metric = REGISTRY.get("hivemind_moe_hedge_total")
        if metric is None:
            return {}
        return {",".join(key): child.value for key, child in metric.series()}

    def failover_total() -> float:
        metric = REGISTRY.get("hivemind_moe_replica_failover_total")
        return sum(child.value for _k, child in metric.series()) if metric is not None else 0.0

    hedges_before = hedge_counts()
    failovers_before = failover_total()

    dht_a = DHT(start=True)
    maddrs = [str(m) for m in dht_a.get_visible_maddrs()]
    server_a = Server.create(
        expert_uids=uids, expert_cls="ffn", hidden_dim=16, dht=dht_a, start=True,
        max_batch_size=64, optim_factory=sgd, device=device,
    )
    dht_b = DHT(initial_peers=maddrs, start=True)
    server_b = Server.create(
        expert_uids=uids, expert_cls="ffn", hidden_dim=16, dht=dht_b, start=True,
        max_batch_size=64, optim_factory=sgd, device=device,
    )
    client_dht = DHT(initial_peers=maddrs, start=True)
    dead_peer_ids: List[str] = []

    stop_event = threading.Event()
    stats = {"ok": 0, "failures": 0, "post_restart_ok": 0}
    phase = {"name": "warm"}
    errors: List[str] = []

    def run_traffic() -> None:
        import numpy as _np

        try:
            infos = None
            for _attempt in range(30):
                infos = get_experts(client_dht, uids)
                if all(i is not None and len(i.replica_set) == 2 for i in infos):
                    break
                time.sleep(0.5)
            if infos is None or any(i is None for i in infos):
                errors.append("serving churn: experts never resolved")
                return
            experts = [RemoteExpert(info, client_dht.node.p2p) for info in infos]
            x = _np.random.RandomState(seed).randn(2, 16).astype(_np.float32)
            while not stop_event.is_set():
                for expert in experts:
                    try:
                        expert.forward_np(x)
                        stats["ok"] += 1
                        if phase["name"] == "restarted":
                            stats["post_restart_ok"] += 1
                    except Exception as e:
                        stats["failures"] += 1
                        errors.append(f"client-visible failure in {phase['name']}: {e!r}")
                time.sleep(0.05)
        except Exception as e:
            errors.append(f"traffic thread: {e!r}")

    traffic = threading.Thread(target=run_traffic)
    traffic.start()
    restarted_server = restarted_dht = None
    # placeholders until the victim is chosen at stall time (an early failure
    # cleans up one pair and leaves the other dangling, like the crash it is)
    survivor_server, survivor_dht = server_a, dht_a
    try:
        time.sleep(duration * stall_fraction)
        # the client's routing turns deterministic once scorecards warm
        # (measured replicas sort by mean latency), so by now traffic has
        # concentrated on ONE replica — the victim must be THAT replica, or
        # the stall lands on a server nobody dials and no hedge can fire
        def replica_requests(peer_b58: str) -> int:
            total = 0
            for uid in uids:
                card = SCORECARDS.card(uid) or {}
                entry = (card.get("replicas") or {}).get(peer_b58)
                if entry:
                    total += int(entry.get("requests", 0))
            return total

        victim_is_b = replica_requests(str(dht_b.peer_id)) >= replica_requests(str(dht_a.peer_id))
        victim_server, victim_dht = (server_b, dht_b) if victim_is_b else (server_a, dht_a)
        survivor_server, survivor_dht = (server_a, dht_a) if victim_is_b else (server_b, dht_b)
        victim_name = "B" if victim_is_b else "A"

        # phase 1: the victim becomes a straggler — its runtime stops draining,
        # so in-flight requests hang past p95 and the client must hedge
        phase["name"] = "stalled"
        logger.warning(f"serving churn: stalling replica {victim_name}'s runtime (hedge bait)")

        async def _stall():
            victim_server.runtime._task.cancel()

        victim_server._runner.run_coroutine(_stall(), return_future=True).result(5)
        time.sleep(duration * (kill_fraction - stall_fraction))

        # phase 2: crash-kill the victim (transport yanked, no clean shutdown —
        # its declarations dangle in the DHT like a real dead process's)
        phase["name"] = "killed"
        logger.warning(f"serving churn: crash-killing replica {victim_name}")
        dead_peer_ids.append(str(victim_dht.peer_id))
        victim_dht.shutdown()
        time.sleep(duration * (restart_fraction - kill_fraction))

        # phase 3: restart under a fresh identity; it re-declares the same uids
        phase["name"] = "restarting"
        logger.warning(f"serving churn: restarting replica {victim_name}")
        restarted_dht = DHT(initial_peers=maddrs, start=True)
        restarted_server = Server.create(
            expert_uids=uids, expert_cls="ffn", hidden_dim=16, dht=restarted_dht,
            start=True, max_batch_size=64, optim_factory=sgd, device=device,
        )
        time.sleep(2.0)
        phase["name"] = "restarted"
        time.sleep(max(duration * (1.0 - restart_fraction) - 2.0, 5.0))

        infos = get_experts(client_dht, uids)
        live_peers = {
            replica.peer_id.to_base58()
            for info in infos if info is not None
            for replica in info.replica_set
        }
        report["resolved_replicas"] = sorted(live_peers)
        restarted_visible = str(restarted_dht.peer_id) in live_peers
    finally:
        stop_event.set()
        traffic.join(timeout=30)

        hedges_after = hedge_counts()
        hedges_fired = hedges_after.get("fired", 0) - hedges_before.get("fired", 0)
        tripped = [
            str(key) for key in EXPERT_BREAKERS.tripped_keys()
            if not any(dead in str(key) for dead in dead_peer_ids)
        ]

        for component in (survivor_server, restarted_server):
            if component is not None:
                component.shutdown()
        for component in (survivor_dht, restarted_dht, client_dht):
            if component is not None:
                component.shutdown()
        EXPERT_BREAKERS.reconfigure(recovery_time=original_recovery)
        reset_all_boards()

    report.update(
        traffic=dict(stats),
        hedges_fired=hedges_fired,
        hedge_outcomes={k: hedges_after.get(k, 0) - hedges_before.get(k, 0) for k in hedges_after},
        replica_failovers=failover_total() - failovers_before,
        breakers_still_tripped=tripped,
        dead_peer_ids=dead_peer_ids,
        errors=errors,
    )
    checks = {
        "traffic_flowed": stats["ok"] > 0,
        "hedge_fired": hedges_fired >= 1,
        "zero_client_visible_failures": stats["failures"] == 0,
        "post_restart_ok": stats["post_restart_ok"] > 0,
        "restarted_replica_visible": bool(restarted_visible),
        "breakers_recovered": not tripped,
    }
    report["checks"] = checks
    report["ok"] = all(checks.values())
    return report


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--peers", type=int, default=4)
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--chaos-fraction", type=float, default=0.6,
                        help="fraction of the soak spent with faults armed")
    parser.add_argument("--no-moe", action="store_true", help="skip the MoE server/client pair")
    parser.add_argument("--churn", action="store_true",
                        help="crash-kill and restart peers on a seeded schedule; "
                             "the verdict then requires state_recovered and zero unverified adoptions")
    parser.add_argument("--churn-kills", type=int, default=None,
                        help="how many kill/restart cycles (default: peers // 3, min 1)")
    parser.add_argument("--checkpoint-root", default=None,
                        help="directory for per-peer crash-safe checkpoints (default: a tempdir)")
    parser.add_argument("--blackbox-root", default=None,
                        help="directory for per-peer black-box spools (default: a tempdir under "
                             "--churn; pass a path to keep victim spools for hivemind-blackbox)")
    parser.add_argument("--spec", default=None,
                        help="HIVEMIND_CHAOS-grammar schedule overriding the default")
    parser.add_argument("--serving", action="store_true",
                        help="serving-churn phase: two replicas of one "
                             "expert grid, one stalled then crash-killed then "
                             "restarted mid-traffic; verdict requires >=1 hedge "
                             "fired, zero client-visible failures, breakers "
                             "recovered after the restart")
    parser.add_argument("--device", default="cuda",
                        help="where the trainers' parameters and the experts live (cuda, or cpu)")
    args = parser.parse_args()
    if args.serving:
        report = run_serving_churn(duration=args.duration, seed=args.seed, device=args.device)
        print(json.dumps(report, indent=2, default=str))
        sys.exit(0 if report["ok"] else 1)
    report = run_soak(
        n_peers=args.peers, duration=args.duration, seed=args.seed,
        chaos_fraction=args.chaos_fraction, include_moe=not args.no_moe, spec=args.spec,
        churn=args.churn, churn_kills=args.churn_kills, checkpoint_root=args.checkpoint_root,
        blackbox_root=args.blackbox_root, device=args.device,
    )
    print(json.dumps(report, indent=2, default=str))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
