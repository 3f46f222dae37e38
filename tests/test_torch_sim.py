"""The port's in-process swarm simulator (``hivemind_tpu_torch/sim/``): the cases of
the JAX package's ``tests/test_swarm_sim.py`` against the port's clock, link matrix,
transport seam and scenarios, keeping that file's ``slow`` marks.

Where a scenario's result is deterministic in both packages, the port's
``ScenarioResult`` is held to the JAX package's field by field: every scenario
summary is (both draw from the same seeded ``random``/numpy streams over the same
protocol logic), so the smoke and ``dht_churn`` summaries are compared whole, and
their digests equal. Only ``diagnostics`` (wall-clock facts) differ, and it stays
outside the digest in both packages."""

import asyncio
import dataclasses
import json

import pytest

from hivemind_tpu.sim import LinkMatrix as JaxLinkMatrix
from hivemind_tpu.sim import run_scenario as jax_run_scenario
from hivemind_tpu_torch.resilience import CHAOS
from hivemind_tpu_torch.sim import (
    LinkMatrix,
    LinkProfile,
    Partition,
    SimNetwork,
    SimPeer,
    VirtualClockEventLoop,
    install_virtual_time,
    run_scenario,
    uninstall_virtual_time,
)
from hivemind_tpu_torch.utils.timed_storage import get_dht_time


@pytest.fixture(autouse=True)
def _restore_wall_time():
    yield
    uninstall_virtual_time()


# ---------------------------------------------------------------------- clock


def test_virtual_clock_jumps_instead_of_waiting():
    loop = VirtualClockEventLoop(start_time=5000.0)
    try:
        asyncio.set_event_loop(loop)

        async def main():
            t0 = loop.time()
            await asyncio.sleep(120.0)  # two virtual minutes, ~zero wall time
            return loop.time() - t0

        import time

        wall0 = time.perf_counter()
        elapsed = loop.run_until_complete(main())
        wall = time.perf_counter() - wall0
        assert elapsed >= 120.0
        assert wall < 5.0  # the sleep must not happen in wall time
    finally:
        asyncio.set_event_loop(None)
        loop.close()


def test_virtual_clock_orders_timers_and_survives_sub_ulp_timeouts():
    # start at epoch magnitude where a double's ulp (~1.2e-7) exceeds tiny
    # timer gaps — the regression that froze the first implementation
    loop = VirtualClockEventLoop(start_time=1_000_000_000.0)
    try:
        asyncio.set_event_loop(loop)
        order = []

        async def sleeper(delay, tag):
            await asyncio.sleep(delay)
            order.append(tag)

        async def main():
            await asyncio.gather(
                sleeper(0.003, "c"), sleeper(1e-9, "a"), sleeper(0.002, "b")
            )

        loop.run_until_complete(main())
        assert order == ["a", "b", "c"]
    finally:
        asyncio.set_event_loop(None)
        loop.close()


def test_virtual_clock_drives_dht_time():
    loop = VirtualClockEventLoop(start_time=777.0)
    install_virtual_time(loop)
    try:
        assert get_dht_time() == 777.0
    finally:
        uninstall_virtual_time()
        loop.close()
    assert get_dht_time() > 1_000_000_000  # wall time restored


# ---------------------------------------------------------------------- link matrix


def test_link_matrix_seeded_and_region_aware():
    links = LinkMatrix(
        seed=9,
        intra=LinkProfile(delay=0.002, bandwidth=125e6, jitter=0.1),
        inter=LinkProfile(delay=0.08, bandwidth=12.5e6, jitter=0.25),
    )
    intra = links.spec("a", "b", "east", "east")
    inter = links.spec("a", "c", "east", "west")
    assert intra.delay < inter.delay
    assert intra.bandwidth > inter.bandwidth
    # per-link jitter is fixed and directional links may differ, but the same
    # (seed, link) always resolves identically
    assert links.spec("a", "c", "east", "west") == inter
    assert LinkMatrix(seed=9, intra=links.intra, inter=links.inter).spec(
        "a", "c", "east", "west"
    ) == inter
    # a different seed moves the jitter
    assert LinkMatrix(seed=10, intra=links.intra, inter=links.inter).spec(
        "a", "c", "east", "west"
    ) != inter
    # the JAX package's matrix resolves every link to the same numbers
    jax_links = JaxLinkMatrix(seed=9, intra=links.intra, inter=links.inter)
    for src, dst, a, b in (("a", "b", "east", "east"), ("a", "c", "east", "west"), ("c", "a", "west", "east")):
        assert dataclasses.astuple(links.spec(src, dst, a, b)) == dataclasses.astuple(jax_links.spec(src, dst, a, b))


def test_partition_schedule_severs_both_directions():
    links = LinkMatrix(seed=1, partitions=(Partition.between("east", "west", 10.0, 20.0),))
    assert not links.partitioned("east", "west", 5.0)
    assert links.partitioned("east", "west", 10.0)
    assert links.partitioned("west", "east", 15.0)
    assert not links.partitioned("east", "east", 15.0)
    assert not links.partitioned("east", "west", 20.0)


# ---------------------------------------------------------------------- transport seam


def test_sim_transport_runs_real_dht_store_get_with_latency():
    """Two real DHTNodes over SimP2P: bootstrap, store, cross-peer get — and the
    whole exchange costs virtual link time, not wall time."""
    loop = VirtualClockEventLoop()
    install_virtual_time(loop)
    try:
        asyncio.set_event_loop(loop)

        async def main():
            net = SimNetwork(LinkMatrix(seed=3), seed=3)
            a = await SimPeer.create(net, "a", "east")
            b = await SimPeer.create(net, "b", "west", bootstrap=a.bootstrap_maddrs())
            t0 = loop.time()
            assert await a.node.store("k", "v", get_dht_time() + 60)
            found = await b.node.get("k")
            assert found is not None and found.value == "v"
            assert loop.time() > t0  # messages paid link delay in virtual time
            assert net.counters["messages"] > 0 and net.counters["bytes"] > 0
            await a.shutdown()
            await b.shutdown()
            await net.shutdown()

        loop.run_until_complete(main())
    finally:
        uninstall_virtual_time()
        asyncio.set_event_loop(None)
        loop.close()


def test_sim_partition_blocks_in_flight_and_new_traffic():
    loop = VirtualClockEventLoop()
    install_virtual_time(loop)
    try:
        asyncio.set_event_loop(loop)

        async def main():
            links = LinkMatrix(seed=4)
            net = SimNetwork(links, seed=4)
            a = await SimPeer.create(net, "a", "east")
            b = await SimPeer.create(net, "b", "west", bootstrap=a.bootstrap_maddrs())
            assert await a.node.store("k", "v", get_dht_time() + 600)
            # sever now
            links.partitions = (Partition.between("east", "west", 0.0, 1e9),)
            ok = await a.node.protocol.call_ping(b.peer_id)
            assert ok is None  # RPC failed cleanly, caller saw unreachable
            assert net.counters["dropped_partition"] > 0
            await a.shutdown()
            await b.shutdown()
            await net.shutdown()

        loop.run_until_complete(main())
    finally:
        uninstall_virtual_time()
        asyncio.set_event_loop(None)
        loop.close()


def test_sim_chaos_link_scope_composes_with_transport():
    """A drop rule scoped to one direction of one link makes that peer's RPCs
    fail while the reverse direction keeps working (satellite: the chaos
    catalog composes with the sim's per-link scoping)."""
    loop = VirtualClockEventLoop()
    install_virtual_time(loop)
    try:
        asyncio.set_event_loop(loop)

        async def main():
            net = SimNetwork(LinkMatrix(seed=6), seed=6)
            a = await SimPeer.create(net, "a")
            b = await SimPeer.create(net, "b", bootstrap=a.bootstrap_maddrs())
            CHAOS.clear()
            CHAOS.reseed(6)
            rule = CHAOS.add_rule(
                "p2p.unary.send", "drop", scope=f"link:{a.peer_id}->{b.peer_id}"
            )
            assert await a.node.protocol.call_ping(b.peer_id) is None  # a->b dropped
            assert await b.node.protocol.call_ping(a.peer_id) is not None  # b->a clean
            assert rule.hits >= 1
            CHAOS.clear()
            await a.shutdown()
            await b.shutdown()
            await net.shutdown()

        loop.run_until_complete(main())
    finally:
        CHAOS.clear()
        uninstall_virtual_time()
        asyncio.set_event_loop(None)
        loop.close()


# ---------------------------------------------------------------------- store batching satellite


def test_store_many_grouped_traversal_places_records_findably():
    """dht/node.py store_many batches keys with coinciding local neighborhoods
    into shared traversals; a bulk publish (>= grouping threshold) must still
    leave every key retrievable from another peer."""
    loop = VirtualClockEventLoop()
    install_virtual_time(loop)
    try:
        asyncio.set_event_loop(loop)

        async def main():
            net = SimNetwork(LinkMatrix(seed=8), seed=8)
            a = await SimPeer.create(net, "a")
            b = await SimPeer.create(net, "b", bootstrap=a.bootstrap_maddrs())
            c = await SimPeer.create(net, "c", bootstrap=a.bootstrap_maddrs())
            keys = [f"bulk-{i:03d}" for i in range(40)]  # above _STORE_GROUPING_MIN_KEYS
            result = await a.node.store_many(keys, [f"v{i}" for i in range(40)], get_dht_time() + 600)
            assert all(result.values())
            found = await c.node.get_many(keys)
            values = {k: (found[k].value if found[k] is not None else None) for k in keys}
            assert values == {f"bulk-{i:03d}": f"v{i}" for i in range(40)}
            for peer in (a, b, c):
                await peer.shutdown()
            await net.shutdown()

        loop.run_until_complete(main())
    finally:
        uninstall_virtual_time()
        asyncio.set_event_loop(None)
        loop.close()


# ---------------------------------------------------------------------- scenarios


def test_smoke_scenario_composite():
    """The ~100-peer tier-1 smoke: DHT fan-out under churn with a link-scoped
    chaos rule, beam search vs oracle on a small grid, matchmaking convergence
    across a two-region partition — all under seeded latency."""
    result = run_scenario("smoke", seed=11)
    s = result.summary
    assert s["chaos_link_rule_hits"] > 0
    assert s["dht"]["publish_messages"] > 0
    assert s["dht"]["get_success_rate"] >= 0.9
    assert s["beam"]["recall_at_beam"] >= 0.95
    mm = s["matchmaking"]
    assert mm["groups_during"] > 0, "matchmaking must keep converging inside partition islands"
    assert mm["cross_region_during_settled"] == 0, "no groups may span a severed link"
    assert mm["convergence_during"] >= 0.75
    assert mm["cross_region_post"] > 0, "regions must mix again after heal"
    # chaos rule was removed by the scenario; nothing may leak into other tests
    assert not CHAOS.enabled
    # the JAX package's simulator gives the same summary, field by field
    reference = jax_run_scenario("smoke", seed=11)
    assert json.loads(result.canonical()) == json.loads(reference.canonical())
    assert result.digest() == reference.digest()


def test_same_seed_twice_is_bit_identical():
    params = dict(peers=24, regions=2, keys=40, churn_fraction=0.15, probe_samples=20,
                  matchmaking_peers=6, matchmaking_rounds=1)
    first = run_scenario("dht_churn", seed=21, **params)
    second = run_scenario("dht_churn", seed=21, **params)
    assert first.canonical() == second.canonical()
    assert first.digest() == second.digest()
    # a different seed must actually change the run (the digest is not vacuous)
    third = run_scenario("dht_churn", seed=22, **params)
    assert third.digest() != first.digest()
    # and the summary is real JSON with the scale facts the bench records
    parsed = json.loads(first.canonical())
    assert parsed["peers"] == 24 and parsed["probes"] == 20
    # and it is the JAX package's summary for the same seed
    assert first.canonical() == jax_run_scenario("dht_churn", seed=21, **params).canonical()


# ---------------------------------------------------------------------- slow soak (chaos suite)


@pytest.mark.slow
@pytest.mark.chaos
def test_thousand_peer_soak_deterministic():
    """A 1000-peer DHT + matchmaking scenario completes on
    CPU in under 5 minutes of wall time and produces bit-identical summaries
    across two runs with the same seed."""
    params = dict(peers=1000, regions=4, keys=1000, churn_fraction=0.10,
                  probe_samples=200, matchmaking_peers=32, matchmaking_rounds=1)
    first = run_scenario("dht_churn", seed=42, **params)
    assert first.diagnostics["wall_seconds"] < 300, first.diagnostics
    assert first.summary["get_success_rate"] >= 0.9
    assert first.summary["matchmaking"]["groups_formed"] > 0
    second = run_scenario("dht_churn", seed=42, **params)
    assert first.digest() == second.digest()


@pytest.mark.slow
@pytest.mark.chaos
def test_ten_thousand_expert_beam_recall():
    """Recall@beam >= 0.95 vs the brute-force oracle at 10k
    experts with no partitions active."""
    result = run_scenario("beam_routing", seed=42, peers=100, servers=50,
                          grid=(10, 10, 100), beam_size=8, trials=8)
    assert result.summary["experts"] == 10_000
    assert result.summary["recall_at_beam"] >= 0.95, result.summary
