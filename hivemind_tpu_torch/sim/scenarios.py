"""Scenario harness for the in-process swarm simulator.

Each scenario builds a seeded :class:`SimNetwork` on a
:class:`VirtualClockEventLoop`, runs real DHT / matchmaking / beam-search logic
over it, and returns a :class:`ScenarioResult` whose ``summary`` is
**deterministic**: every value derives from virtual time, seeded RNG streams
and message contents — never from wall clocks or memory addresses — so two
runs with the same seed produce byte-identical canonical JSON (asserted by
tests/test_torch_sim.py, which also holds it to the JAX package's). Wall-time
facts (how fast the sim ran) live in ``diagnostics``, outside the digest.

Scenarios:

- ``dht_churn`` — N-peer DHT: bootstrap, bulk publish, seeded crash churn +
  replacements, republish, store/get fan-out probes; optional matchmaking
  cohort (the 1k-peer ROADMAP soak is this scenario at ``peers=1000``).
- ``beam_routing`` — a full expert grid declared through the real prefix
  encoding; MoEBeamSearcher recall@beam vs a brute-force oracle (ROADMAP: 10k
  experts).
- ``matchmaking_partition`` — two regions, a timed WAN partition: groups must
  keep forming inside each island (no cross-region groups while severed) and
  mix again after heal.
- ``smoke`` — small composite of all three plus a link-scoped chaos rule,
  tier-1-safe.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import random
import statistics
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hivemind_tpu_torch.moe.client.beam_search import MoEBeamSearcher
from hivemind_tpu_torch.moe.server.dht_handler import declare_experts
from hivemind_tpu_torch.resilience import CHAOS
from hivemind_tpu_torch.sim.clock import VirtualClockEventLoop, install_virtual_time, uninstall_virtual_time
from hivemind_tpu_torch.sim.network import LinkMatrix, LinkProfile, Partition, SimNetwork
from hivemind_tpu_torch.sim.peer import SimPeer
from hivemind_tpu_torch.telemetry.blackbox import BlackBox
from hivemind_tpu_torch.telemetry.ledger import RoundLedger
from hivemind_tpu_torch.telemetry.registry import MetricsRegistry
from hivemind_tpu_torch.telemetry.tracing import (
    add_span_listener,
    remove_span_listener,
    seed_trace_ids,
    trace,
)
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)


@dataclass
class ScenarioResult:
    name: str
    seed: int
    summary: dict
    diagnostics: dict = field(default_factory=dict)

    def canonical(self) -> str:
        """Canonical JSON of the deterministic summary (digest input)."""
        return json.dumps(self.summary, sort_keys=True, separators=(",", ":"))

    def digest(self) -> str:
        return hashlib.sha256(self.canonical().encode()).hexdigest()


def run_scenario(name: str, seed: int = 0, **params) -> ScenarioResult:
    """Run one scenario to completion on a fresh virtual-clock loop.

    Installs the virtual swarm-time source and seeds every RNG stream the
    scenario touches; both are restored/irrelevant after return, so scenarios
    compose with the rest of a test process.
    """
    scenario = _SCENARIOS.get(name)
    if scenario is None:
        raise ValueError(f"unknown scenario {name!r} (choose from {sorted(_SCENARIOS)})")
    loop = VirtualClockEventLoop()
    install_virtual_time(loop)
    rng_state = random.getstate()
    random.seed(zlib.crc32(f"{name}|{seed}".encode()))
    # trace/span ids are OS-seeded by default (forked peers must diverge);
    # inside a scenario they come from the scenario seed so per-peer black-box
    # spools are bit-identical across same-seed runs
    seed_trace_ids(zlib.crc32(f"{name}|{seed}|trace".encode()))
    if CHAOS.enabled:
        CHAOS.reseed(seed)  # replaying the same seed must replay the same faults
    wall_started = time.perf_counter()
    try:
        asyncio.set_event_loop(loop)
        vtime_started = loop.time()
        summary = loop.run_until_complete(scenario(seed=seed, **params))
        sim_seconds = loop.time() - vtime_started
    finally:
        uninstall_virtual_time()
        random.setstate(rng_state)  # the process's global stream is not ours to keep
        seed_trace_ids(None)  # back to OS entropy: live peers must diverge again
        with contextlib.suppress(Exception):
            _drain_loop(loop)
        asyncio.set_event_loop(None)
        loop.close()
    wall_seconds = time.perf_counter() - wall_started
    return ScenarioResult(
        name=name,
        seed=seed,
        summary=summary,
        diagnostics={
            "wall_seconds": round(wall_seconds, 3),
            "sim_seconds": round(sim_seconds, 3),
            "sim_seconds_per_wall_second": round(sim_seconds / max(wall_seconds, 1e-9), 2),
            "chaos_injections": CHAOS.stats(),
        },
    )


def _drain_loop(loop: asyncio.AbstractEventLoop) -> None:
    """Cancel and reap whatever the scenario left behind so loop.close() is quiet."""
    pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for task in pending:
        task.cancel()
    if pending:
        loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))


# ---------------------------------------------------------------------- helpers


def _region_name(index: int, regions: int) -> str:
    return f"r{index % max(regions, 1)}"


async def _build_swarm(
    network: SimNetwork,
    count: int,
    *,
    seed: int,
    regions: int,
    name_prefix: str = "p",
    start_index: int = 0,
    existing: Sequence[SimPeer] = (),
    batch: int = 32,
    **dht_kwargs,
) -> List[SimPeer]:
    """Spawn ``count`` peers in deterministic batches; each bootstraps off up to
    3 peers created strictly before its batch (so batch concurrency cannot race
    a peer against its own bootstrap target)."""
    rng = random.Random(zlib.crc32(f"{seed}|bootstrap|{name_prefix}|{start_index}".encode()))
    peers: List[SimPeer] = list(existing)
    created: List[SimPeer] = []
    index = start_index
    while len(created) < count:
        # the very first peer seeds the swarm alone; everyone after bootstraps
        # off peers created in strictly earlier batches
        n_batch = 1 if not peers else min(batch, count - len(created))
        known = list(peers)  # bootstrap pool: everyone from earlier batches
        coros = []
        for _ in range(n_batch):
            name = f"{name_prefix}{index:05d}"
            region = _region_name(index, regions)
            if known:
                targets = rng.sample(known, k=min(3, len(known)))
                bootstrap = [maddr for t in targets for maddr in t.bootstrap_maddrs()]
            else:
                bootstrap = []
            coros.append(
                SimPeer.create(network, name, region, bootstrap=bootstrap, **dht_kwargs)
            )
            index += 1
        batch_peers = await asyncio.gather(*coros)
        created.extend(batch_peers)
        peers.extend(batch_peers)
    return created


def _routing_table_stats(peers: Sequence[SimPeer]) -> dict:
    sizes = sorted(len(p.node.protocol.routing_table) for p in peers if p.p2p.alive)
    if not sizes:
        return {"min": 0, "median": 0, "max": 0}
    return {
        "min": sizes[0],
        "median": int(statistics.median(sizes)),
        "max": sizes[-1],
    }


# ---------------------------------------------------------------------- dht_churn


async def _scenario_dht_churn(
    seed: int,
    *,
    peers: int = 1000,
    regions: int = 4,
    keys: int = 1000,
    churn_fraction: float = 0.10,
    replacements: Optional[int] = None,
    probe_samples: int = 200,
    matchmaking_peers: int = 0,
    matchmaking_rounds: int = 2,
    min_matchmaking_time: float = 4.0,
    blackbox_root: Optional[str] = None,
) -> dict:
    network = SimNetwork(LinkMatrix(seed=seed), seed=seed)
    rng = random.Random(zlib.crc32(f"{seed}|churn".encode()))
    swarm = await _build_swarm(network, peers, seed=seed, regions=regions)

    # --- bulk publish: each key belongs to one owner; owners store in ONE
    # store_many call so the shared-traversal batching (dht/node.py) is on the
    # hot path exactly like a republish storm
    owners: Dict[str, SimPeer] = {}
    per_owner: Dict[int, List[str]] = {}
    for key_index in range(keys):
        owner_index = key_index % len(swarm)
        key = f"key-{key_index:05d}"
        owners[key] = swarm[owner_index]
        per_owner.setdefault(owner_index, []).append(key)

    async def _publish(owner_index: int, owned_keys: List[str]) -> int:
        owner = swarm[owner_index]
        expiration = get_dht_time() + 600.0
        result = await owner.node.store_many(
            owned_keys,
            [{"owner": owner.name, "k": k} for k in owned_keys],
            expiration,
        )
        return sum(bool(v) for v in result.values())

    publish_started_msgs = network.counters["messages"]
    publish_ok = 0
    owner_items = sorted(per_owner.items())
    for start in range(0, len(owner_items), 64):
        chunk = owner_items[start : start + 64]
        publish_ok += sum(await asyncio.gather(*(_publish(i, ks) for i, ks in chunk)))
    publish_msgs = network.counters["messages"] - publish_started_msgs

    # --- churn: seeded crash-kills, then replacements bootstrapping off survivors
    n_kill = int(len(swarm) * churn_fraction)
    victims = sorted(rng.sample(range(len(swarm)), k=n_kill))
    for index in victims:
        swarm[index].crash()
    survivors = [p for p in swarm if p.p2p.alive]
    n_replace = n_kill if replacements is None else replacements
    replacement_peers = await _build_swarm(
        network,
        n_replace,
        seed=seed,
        regions=regions,
        name_prefix="q",
        start_index=len(swarm),
        existing=survivors,
    )
    live = survivors + replacement_peers

    # --- republish: surviving owners re-store with fresh expirations; the
    # message delta is the republish load the satellite batching targets
    republish_started_msgs = network.counters["messages"]
    republish_ok = 0
    live_owner_items = [(i, ks) for i, ks in owner_items if swarm[i].p2p.alive]
    for start in range(0, len(live_owner_items), 64):
        chunk = live_owner_items[start : start + 64]
        republish_ok += sum(await asyncio.gather(*(_publish(i, ks) for i, ks in chunk)))
    republish_msgs = network.counters["messages"] - republish_started_msgs

    # --- optional matchmaking cohort riding the same churned swarm
    matchmaking_summary = None
    if matchmaking_peers > 0:
        cohort = live[: min(matchmaking_peers, len(live))]
        for peer in cohort:
            await peer.enable_matchmaking(
                "sim_soak", target_group_size=4, min_matchmaking_time=min_matchmaking_time
            )
        matchmaking_summary = await _run_matchmaking_rounds(
            network,
            cohort,
            rounds=matchmaking_rounds,
            window=min_matchmaking_time * 6,
            blackbox_root=blackbox_root,
        )

    # --- probes: seeded sample of keys, each read from a seeded live reader
    probe_keys = sorted(rng.sample(sorted(owners), k=min(probe_samples, len(owners))))
    hits = 0
    for key in probe_keys:
        reader = live[rng.randrange(len(live))]
        found = await reader.node.get(key)
        if found is not None and isinstance(found.value, dict) and found.value.get("k") == key:
            hits += 1
    get_success_rate = hits / max(len(probe_keys), 1)

    summary = {
        "scenario": "dht_churn",
        "peers": peers,
        "regions": regions,
        "keys": keys,
        "publish_ok": publish_ok,
        "publish_messages": publish_msgs,
        "churn_killed": n_kill,
        "replacements": n_replace,
        "republish_ok": republish_ok,
        "republish_messages": republish_msgs,
        "probes": len(probe_keys),
        "probe_hits": hits,
        "get_success_rate": round(get_success_rate, 4),
        "routing_table": _routing_table_stats(live),
        "network": dict(sorted(network.counters.items())),
        "sim_seconds": round(network.rel_time(), 3),
    }
    if matchmaking_summary is not None:
        summary["matchmaking"] = matchmaking_summary
    await _teardown(network, swarm + replacement_peers)
    return summary


# ---------------------------------------------------------------------- beam_routing


def _expert_uid(prefix: str, coords: Tuple[int, ...]) -> str:
    return prefix + ".".join(str(c) for c in coords)


async def _scenario_beam_routing(
    seed: int,
    *,
    peers: int = 100,
    servers: int = 50,
    grid: Tuple[int, ...] = (10, 10, 100),
    beam_size: int = 8,
    trials: int = 16,
    regions: int = 2,
) -> dict:
    network = SimNetwork(LinkMatrix(seed=seed), seed=seed)
    swarm = await _build_swarm(network, peers, seed=seed, regions=regions)
    server_peers = swarm[: min(servers, len(swarm))]
    client = swarm[-1]
    prefix = "ffn."

    # full grid coverage, experts spread over servers by seeded hash — at the
    # default grid this is the ROADMAP's 10k-expert declaration load
    coords_list: List[Tuple[int, ...]] = [()]
    for dim_size in grid:
        coords_list = [c + (i,) for c in coords_list for i in range(dim_size)]
    assignments: Dict[int, List[str]] = {}
    for coords in coords_list:
        uid = _expert_uid(prefix, coords)
        owner = zlib.crc32(f"{seed}|expert|{uid}".encode()) % len(server_peers)
        assignments.setdefault(owner, []).append(uid)

    declare_started_msgs = network.counters["messages"]
    expiration = get_dht_time() + 1200.0

    async def _declare(owner: int) -> None:
        peer = server_peers[owner]
        await declare_experts(peer.dht, assignments[owner], expiration, wait=False)

    owners_sorted = sorted(assignments)
    for start in range(0, len(owners_sorted), 16):
        await asyncio.gather(*(_declare(o) for o in owners_sorted[start : start + 16]))
    declare_msgs = network.counters["messages"] - declare_started_msgs

    searcher = MoEBeamSearcher(client.dht, prefix, grid_size=grid)
    recalls: List[float] = []
    for trial in range(trials):
        trial_rng = np.random.default_rng(seed * 100_003 + trial)
        scores = [trial_rng.standard_normal(dim_size).astype(np.float32) for dim_size in grid]
        # oracle: brute-force top-k over the (separable) full grid
        total = scores[0]
        for dim_scores in scores[1:]:
            total = total[..., None] + dim_scores
        flat = total.reshape(-1)
        top = np.argsort(-flat, kind="stable")[:beam_size]
        oracle = {
            _expert_uid(prefix, tuple(int(c) for c in np.unravel_index(int(ix), grid)))
            for ix in top
        }
        found = await searcher._find_best_experts_async(
            client.node, [s[None] for s in scores], beam_size
        )
        found_uids = {info.uid for info in found[0]}
        recalls.append(len(found_uids & oracle) / beam_size)

    summary = {
        "scenario": "beam_routing",
        "peers": peers,
        "servers": len(server_peers),
        "experts": len(coords_list),
        "grid": list(grid),
        "beam_size": beam_size,
        "trials": trials,
        "declare_messages": declare_msgs,
        "recall_at_beam": round(float(np.mean(recalls)), 6),
        "min_recall": round(float(np.min(recalls)), 6),
        "network": dict(sorted(network.counters.items())),
        "sim_seconds": round(network.rel_time(), 3),
    }
    await _teardown(network, swarm)
    return summary


# ---------------------------------------------------------------------- matchmaking_partition


def _peer_stagger(seed: int, name: str, spread: float) -> float:
    """Deterministic per-peer start offset. Virtual time is perfectly
    synchronized, so peers launched by one ``gather`` would all declare the
    SAME matchmaking expiration and nobody could ever lead anybody (the
    earliest-expiration-leads DAG needs distinct deadlines). Real swarms are
    desynchronized by wall-clock jitter; the sim makes that jitter seeded."""
    return (zlib.crc32(f"{seed}|stagger|{name}".encode()) % 10_000) / 10_000 * spread


async def _match_loop(
    network: SimNetwork,
    peer: SimPeer,
    name_of: Dict,
    records: List[Tuple[float, Tuple[str, ...]]],
    *,
    rounds: Optional[int] = None,
    window: Optional[float] = None,
    deadline: Optional[float] = None,
    min_lead: float = 0.0,
    poll: float = 0.25,
    simulate_allreduce: bool = False,
) -> None:
    """One peer's matchmaking loop, shared by every scenario: staggered start,
    repeated ``look_for_group`` bounded by ``rounds`` attempts and/or a
    virtual-time ``deadline`` (stop when less than ``min_lead`` remains; with a
    deadline a timed-out attempt ends the loop), appending deterministic
    ``(rel_time, sorted_member_names)`` records. Each attempt is traced as an
    ``averaging.matchmaking`` span (the round ledger's wait-time signal), and
    with ``simulate_allreduce`` a formed group runs one synthesized
    :meth:`SimPeer.simulate_allreduce_round` so virtual-time ledger records
    with straggler attribution exist."""
    await asyncio.sleep(_peer_stagger(network.seed, peer.name, spread=2.0))
    attempts = 0
    while rounds is None or attempts < rounds:
        if not peer.p2p.alive:
            return
        timeout = window
        if deadline is not None:
            remaining = deadline - network.rel_time()
            if remaining <= min_lead:
                return
            timeout = remaining if window is None else min(window, remaining)
        attempts += 1
        timed_out = False
        with trace("averaging.matchmaking", peer=peer.name) as mm_span:
            try:
                group = await asyncio.wait_for(peer.look_for_group(), timeout=timeout)
            except asyncio.TimeoutError:
                group, timed_out = None, True
            except Exception:
                group = None
            if mm_span is not None:
                mm_span.set(
                    "outcome",
                    "timeout" if timed_out else ("matched" if group is not None else "failed"),
                )
        if timed_out and deadline is not None:
            return
        if group is not None:
            members = tuple(sorted(name_of.get(pid, str(pid)) for pid in group.peer_ids))
            records.append((round(network.rel_time(), 3), members))
            if simulate_allreduce:
                await peer.simulate_allreduce_round(group)
        await asyncio.sleep(poll)


def _dedupe_groups(records: List[Tuple[float, Tuple[str, ...]]]) -> Dict[Tuple[str, ...], float]:
    """One group assembles once but is recorded by every member: dedupe on the
    member set, keep the earliest formation time (deterministic)."""
    groups: Dict[Tuple[str, ...], float] = {}
    for formed_at, members in records:
        if members not in groups or formed_at < groups[members]:
            groups[members] = formed_at
    return groups


async def _run_matchmaking_rounds(
    network: SimNetwork,
    cohort: Sequence[SimPeer],
    *,
    rounds: int,
    window: float,
    simulate_allreduce: bool = True,
    blackbox_root: Optional[str] = None,
) -> dict:
    """Every cohort peer repeatedly looks for a group for ``rounds`` attempts
    (bounded by ``window`` sim-seconds each); returns deterministic group facts.

    With ``simulate_allreduce`` (the default) every formed group also runs a
    synthesized all-reduce round, attributed by a PRIVATE :class:`RoundLedger`
    on a private empty registry — the process-wide registry's counters are
    cross-test noise and would poison the deterministic digest. The resulting
    virtual-time ledger summary (rounds, phase quantiles, straggler scores)
    rides the returned dict. ``blackbox_root`` additionally arms one
    :class:`BlackBox` spool per cohort peer under ``<root>/<peer name>``,
    subscribed to the same private ledger — per-peer spools bit-identical
    across same-seed runs."""
    name_of = {peer.peer_id: peer.name for peer in cohort}
    records: List[Tuple[float, Tuple[str, ...]]] = []
    ledger: Optional[RoundLedger] = None
    boxes: List[BlackBox] = []
    if simulate_allreduce:
        ledger = RoundLedger(registry=MetricsRegistry())
        add_span_listener(ledger.on_span)
        if blackbox_root is not None:
            for peer in cohort:
                boxes.append(
                    BlackBox(
                        Path(blackbox_root) / peer.name,
                        peer=peer.name,
                        peer_filter=peer.name,
                        ledger=ledger,
                        metrics_interval=None,
                    )
                )
    try:
        await asyncio.gather(
            *(
                _match_loop(
                    network, peer, name_of, records,
                    rounds=rounds, window=window, simulate_allreduce=simulate_allreduce,
                )
                for peer in cohort
            )
        )
    finally:
        for box in boxes:
            box.close()
        if ledger is not None:
            remove_span_listener(ledger.on_span)
    groups = _dedupe_groups(records)
    matched = {name for members in groups for name in members}
    summary = {
        "cohort": len(cohort),
        "rounds_per_peer": rounds,
        "groups": sorted([t, list(m)] for m, t in groups.items()),
        "groups_formed": len(groups),
        "peers_matched": len(matched),
        "group_sizes": sorted(len(m) for m in groups),
    }
    if ledger is not None:
        summary["ledger"] = ledger.summary()
    return summary


async def _scenario_matchmaking_partition(
    seed: int,
    *,
    peers: int = 16,
    target_group_size: int = 4,
    min_matchmaking_time: float = 4.0,
    request_timeout: float = 3.0,
    partition_delay: float = 10.0,
    partition_length: float = 60.0,
    post_heal: float = 60.0,
) -> dict:
    regions = ("east", "west")
    links = LinkMatrix(
        seed=seed,
        intra=LinkProfile(delay=0.004, bandwidth=125e6, jitter=0.1),
        inter=LinkProfile(delay=0.08, bandwidth=12.5e6, jitter=0.25),
    )
    network = SimNetwork(links, seed=seed)
    swarm = await _build_swarm(network, peers, seed=seed, regions=2)
    region_of = {}
    for index, peer in enumerate(swarm):
        region_of[peer.name] = regions[index % 2]
    # NB: _region_name gave peers regions "r0"/"r1"; relabel to east/west for
    # the partition (the matrix matches on the SimP2P region tag)
    for peer in swarm:
        peer.p2p.region = region_of[peer.name]

    for peer in swarm:
        await peer.enable_matchmaking(
            "sim_partition",
            target_group_size=target_group_size,
            min_matchmaking_time=min_matchmaking_time,
            request_timeout=request_timeout,
        )

    # schedule the partition relative to NOW (bootstrap already consumed sim time)
    partition_start = network.rel_time() + partition_delay
    partition_end = partition_start + partition_length
    links.partitions = (Partition.between("east", "west", partition_start, partition_end),)
    scenario_end = partition_end + post_heal

    name_of = {peer.peer_id: peer.name for peer in swarm}
    records: List[Tuple[float, Tuple[str, ...]]] = []
    await asyncio.gather(
        *(
            _match_loop(
                network, peer, name_of, records,
                deadline=scenario_end, min_lead=min_matchmaking_time, poll=0.5,
            )
            for peer in swarm
        )
    )
    groups = _dedupe_groups(records)

    def _phase(formed_at: float) -> str:
        if formed_at < partition_start:
            return "pre"
        if formed_at < partition_end:
            return "during"
        return "post"

    phases = {"pre": [], "during": [], "post": []}
    for members, formed_at in groups.items():
        regions_in_group = {region_of[name] for name in members}
        phases[_phase(formed_at)].append(
            {"t": formed_at, "members": list(members), "cross_region": len(regions_in_group) > 1}
        )
    for phase_groups in phases.values():
        phase_groups.sort(key=lambda g: (g["t"], g["members"]))
    matched_during = {
        name for g in phases["during"] for name in g["members"]
    }
    # groups assembled moments after the cut may have courted cross-region
    # BEFORE it: the settled window excludes in-flight state, so an assertion
    # "no cross-region groups while severed" has a principled boundary
    settle_margin = min_matchmaking_time + 2.0 * request_timeout  # lead time + 2 RPC timeouts
    cross_region_during_settled = sum(
        g["cross_region"] for g in phases["during"] if g["t"] >= partition_start + settle_margin
    )

    summary = {
        "scenario": "matchmaking_partition",
        "peers": peers,
        "target_group_size": target_group_size,
        "partition": [round(partition_start, 3), round(partition_end, 3)],
        "groups_pre": len(phases["pre"]),
        "groups_during": len(phases["during"]),
        "groups_post": len(phases["post"]),
        "cross_region_during": sum(g["cross_region"] for g in phases["during"]),
        "cross_region_during_settled": cross_region_during_settled,
        "cross_region_post": sum(g["cross_region"] for g in phases["post"]),
        "peers_matched_during": len(matched_during),
        "convergence_during": round(len(matched_during) / peers, 4),
        "groups": phases,
        "network": dict(sorted(network.counters.items())),
        "sim_seconds": round(network.rel_time(), 3),
    }
    await _teardown(network, swarm)
    return summary


# ---------------------------------------------------------------------- smoke composite


async def _scenario_smoke(
    seed: int,
    *,
    dht_peers: int = 60,
    beam_peers: int = 24,
    matchmaking_peers: int = 12,
) -> dict:
    """Small composite of all three scenarios under one loop — plus a
    link-scoped chaos rule, proving the 14-point catalog composes with the
    sim's directional link scoping."""
    rule = CHAOS.add_rule(
        "p2p.unary.send", "delay", delay=0.05, times=200, scope="link:*->*"
    )
    try:
        dht_summary = await _scenario_dht_churn(
            seed,
            peers=dht_peers,
            regions=2,
            keys=90,
            churn_fraction=0.15,
            probe_samples=60,
        )
        chaos_hits = rule.hits
    finally:
        CHAOS.remove_rule(rule)
    beam_summary = await _scenario_beam_routing(
        seed, peers=beam_peers, servers=12, grid=(4, 4, 8), beam_size=4, trials=4
    )
    matchmaking_summary = await _scenario_matchmaking_partition(
        seed,
        peers=matchmaking_peers,
        partition_delay=6.0,
        partition_length=40.0,
        post_heal=40.0,
    )
    return {
        "scenario": "smoke",
        "chaos_link_rule_hits": chaos_hits,
        "dht": dht_summary,
        "beam": beam_summary,
        "matchmaking": matchmaking_summary,
    }


# ---------------------------------------------------------------------- plumbing


async def _teardown(network: SimNetwork, peers: Sequence[SimPeer]) -> None:
    for peer in peers:
        with contextlib.suppress(Exception):
            await peer.shutdown()
    await network.shutdown()


_SCENARIOS = {
    "dht_churn": _scenario_dht_churn,
    "beam_routing": _scenario_beam_routing,
    "matchmaking_partition": _scenario_matchmaking_partition,
    "smoke": _scenario_smoke,
}


def scenario_names() -> List[str]:
    return sorted(_SCENARIOS)
