"""The port's mesh bridge and MeshAverager against the JAX package's: on four spawned
gloo ranks the bridge assembles each leaf on rank 0's host from one rank per region and
scatters it back unchanged; ``mesh_mean`` equals JAX's ``pmean`` over the same replicas;
and a one-rank MeshAverager averages with a JAX averager over the lossless wire, both
ending with the same bits."""

from __future__ import annotations

import threading

import jax
import numpy as np
import pytest

from hivemind_tpu.averaging import DecentralizedAverager as JaxAverager
from hivemind_tpu.compression import NoCompression as JaxNoCompression
from hivemind_tpu.dht import DHT as JaxDHT
from hivemind_tpu.parallel import MeshTensorBridge as JaxBridge
from hivemind_tpu.parallel import make_mesh as jax_make_mesh
from hivemind_tpu_torch.parallel.mesh import P

import torch_mesh_ranks as ranks

WORLD = 4
U32 = 2.0**-24


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(WORLD)
    yield pool
    pool.close()


def test_bridge_round_trip_pulls_each_region_once(pool):
    """At (1, 2, 2): a tensor-parallel Dense kernel (its torch weight the transpose), a
    sharded bias and a replicated leaf reach rank 0's mirrors whole in the flax layout;
    rank 0 receives exactly the one remote region of each sharded leaf (from the rank at
    tp 1, sp 0), nothing of the replicated one, and the sp replicas send nothing; the
    scatter gives every rank back its own block bit for bit."""
    rng = np.random.RandomState(3)
    cases = [(rng.randn(8, 12).astype(np.float32), P(None, "tp"), True),
             (rng.randn(12).astype(np.float32), P("tp"), False),
             (rng.randn(5, 3).astype(np.float32), P(), False)]
    readings = pool.run(ranks.bridge_round_trip, (1, 2, 2), cases)
    mirrors = readings[0]["mirrors"]
    for mirror, (whole, _, _) in zip(mirrors, cases):
        np.testing.assert_array_equal(mirror, whole)
    assert readings[0]["received_from"] == [2, 2]
    assert all(r["mirrors"] is None and r["received_from"] == [] for r in readings[1:])
    assert [r["regions_sent"] for r in readings] == [0, 0, 2, 0]
    assert all(r["round_trip"] for r in readings)


@pytest.mark.parametrize("shape", [(2, 2, 1), (4, 1, 1)], ids=["2x2x1", "4x1x1"])
def test_mesh_mean_matches_the_jax_pmean(pool, shape):
    """Each dp replica's own values (the same on its tp ranks) reduced over dp on the
    ranks equal JAX's ``MeshTensorBridge.mesh_mean`` of the stacked replicas within
    fp32 rounding of the sum, and the streamed reduce-and-gather gives rank 0 the same."""
    dp = shape[0]
    rng = np.random.RandomState(4)
    replicas = [[rng.randn(6, 4).astype(np.float32), rng.randn(10).astype(np.float32)] for _ in range(dp)]
    per_rank = [replicas[rank // (WORLD // dp)] for rank in range(WORLD)]
    readings = pool.run(ranks.bridge_mesh_mean, shape, per_rank, "dp")
    jax_mesh = jax_make_mesh(*shape, devices=jax.devices()[:WORLD])
    stacked = [jax.device_put(np.stack([r[k] for r in replicas]),
                              jax.sharding.NamedSharding(jax_mesh, jax.sharding.PartitionSpec("dp")))
               for k in range(2)]
    expected = [np.asarray(x) for x in JaxBridge(jax_mesh).mesh_mean(stacked, "dp")]
    for reading in readings:
        for got, want, k in zip(reading["mean"], expected, range(2)):
            scale = np.abs(np.stack([r[k] for r in replicas])).max(axis=0)
            assert np.all(np.abs(got - want) <= 2 * dp * U32 * scale)
    for got, want in zip(readings[0]["gathered"], readings[0]["mean"]):
        np.testing.assert_array_equal(got, want)


def test_mesh_averager_round_with_a_jax_averager_is_bit_identical():
    """A one-rank mesh's MeshAverager and a JAX DecentralizedAverager average two tensors
    over the lossless wire: each ends bit for bit with the replay of the two-peer round
    (whichever peer reduces a part sums the two fp32 values, halves the sum and sends
    each peer mean − own, which it adds to its own value); the mesh advertises one
    host's bandwidth."""
    rng = np.random.RandomState(6)
    mine = [rng.randn(300).astype(np.float32), rng.randn(7, 5).astype(np.float32)]
    theirs = [rng.randn(300).astype(np.float32), rng.randn(7, 5).astype(np.float32)]
    jax_dht = JaxDHT(start=True)
    single = ranks.RankPool(1)
    jax_result = {}
    try:
        averager = JaxAverager([t.copy() for t in theirs], jax_dht, prefix="meshavg", target_group_size=2,
                               min_group_size=2, min_matchmaking_time=2.0, compression=JaxNoCompression(), start=True)

        def run_jax():
            jax_result["ok"] = averager.step(timeout=40) is not None

        thread = threading.Thread(target=run_jax)
        thread.start()
        (reading,) = single.run(ranks.mesh_averager_round, mine, [str(m) for m in jax_dht.get_visible_maddrs()],
                                "meshavg", timeout=90)
        thread.join(60)
        with averager.get_tensors() as tensors:
            jax_values = [np.array(t, copy=True) for t in tensors]
        averager.shutdown()
    finally:
        single.close()
        jax_dht.shutdown()
    assert reading["ok"] and jax_result.get("ok")
    assert reading["bandwidth"] == 1.0e8
    for got, got_jax, a, b in zip(reading["tensors"], jax_values, mine, theirs):
        mean = (a + b) / np.float32(2)
        assert got.tobytes() == (a + (mean - a)).tobytes()
        assert got_jax.tobytes() == (b + (mean - b)).tobytes()
