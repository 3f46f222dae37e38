"""The port's mesh (``hivemind_tpu_torch.parallel.mesh``) against the JAX package's: four
spawned gloo ranks sit at the coordinates of the JAX mesh of four devices, shard every
ALBERT leaf and the batch as JAX's shardings do, rotate blocks exactly, and refuse the
meshes the job cannot hold."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec

from hivemind_tpu.models import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models import AlbertForMaskedLM as JaxAlbertForMaskedLM
from hivemind_tpu.parallel import make_mesh as jax_make_mesh
from hivemind_tpu.parallel import params_shardings as jax_params_shardings
from hivemind_tpu_torch.convert import flax_path
from hivemind_tpu_torch.models import AlbertConfig, AlbertForMaskedLM
from hivemind_tpu_torch.parallel import params_shardings
from hivemind_tpu_torch.parallel.mesh import P

import torch_mesh_ranks as ranks

WORLD = 4
SHAPES = [(1, 2, 2), (2, 1, 2), (2, 2, 1)]
# (whole flax shape, spec, transposed): a query kernel, an ffn_down kernel, a bias, a batch-like block
REGION_CASES = [((8, 12), P(None, "tp"), True), ((12, 8), P("tp", None), True), ((12,), P("tp"), False),
                ((8, 16), P("dp", "sp"), False)]


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(WORLD)
    yield pool
    pool.close()


def _jax_regions(jax_mesh, spec, shape):
    """{device id: [(start, stop), ...]} of a JAX sharding of ``shape``."""
    indices = JaxNamedSharding(jax_mesh, PartitionSpec(*spec)).devices_indices_map(shape)
    return {device.id: [(s.start or 0, s.stop if s.stop is not None else n) for s, n in zip(index, shape)]
            for device, index in indices.items()}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rank_coordinates_and_regions_match_the_jax_mesh(pool, shape):
    """Rank r sits where JAX's ``make_mesh(dp, tp, sp)`` puts device r, its ranks along
    each axis are JAX's devices along it, and its region of each sharded tensor is the
    block JAX's NamedSharding gives device r."""
    jax_mesh = jax_make_mesh(*shape, devices=jax.devices()[:WORLD])
    readings = pool.run(ranks.mesh_layout, shape, REGION_CASES)
    for reading in readings:
        coordinate = tuple(reading["coordinate"][a] for a in ("dp", "tp", "sp"))
        assert jax_mesh.devices[coordinate].id == reading["rank"]
        for axis_index, axis in enumerate(("dp", "tp", "sp")):
            line = [slice(None) if a == axis_index else c for a, c in enumerate(coordinate)]
            assert [d.id for d in jax_mesh.devices[tuple(line)].reshape(-1)] == reading["axis_ranks"][axis]
        for (full, spec, _), region in zip(REGION_CASES, reading["regions"]):
            assert _jax_regions(jax_mesh, spec, full)[reading["rank"]] == [tuple(r) for r in region]
        assert _jax_regions(jax_mesh, ("dp", "sp"), (8, 16))[reading["rank"]] == [tuple(r) for r in reading["batch"]]
        assert reading["hosts"] == 1


def test_every_albert_leaf_has_the_jax_spec():
    """``params_shardings`` over the port model's parameters gives each leaf the spec
    JAX's ``params_shardings`` gives the same flax path (tensor-parallel query, key,
    value, ffn_up columns and attention_out, ffn_down rows; the rest replicated)."""
    jax_config = JaxAlbertConfig.tiny()
    jax_params = jax.eval_shape(JaxAlbertForMaskedLM(jax_config).init, jax.random.PRNGKey(0),
                                np.zeros((1, 8), np.int32))["params"]
    jax_mesh = jax_make_mesh(2, 2, 2)
    jax_specs = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(jax_params_shardings(jax_params, jax_mesh))[0]:
        jax_specs["/".join(str(entry.key) for entry in path)] = tuple(sharding.spec)
    model = AlbertForMaskedLM(AlbertConfig.tiny(), device="meta")
    port = {"/".join(flax_path(name, p.ndim)[0]): sharding.spec
            for (name, p), sharding in zip(model.named_parameters(), params_shardings(model.named_parameters(), None).values())}
    assert sorted(port) == sorted(jax_specs)
    for path, spec in port.items():
        assert spec == jax_specs[path], path
    assert sum(1 for spec in port.values() if "tp" in spec) == 10


def test_ring_shift_moves_exact_bytes_through_gloo(pool):
    """One step each way along sp, bf16 and fp32: every rank receives its neighbor's
    block bit for bit. The rule of the transport: over gloo, ranks whose tensors lie on a
    card stage them through pinned host buffers (gloo moves host tensors only); CPU
    tensors, and card tensors over nccl, move as they are."""
    readings = pool.run(ranks.ring_shift_exact, (1, 1, 4))
    for reading in readings:
        here = reading["coordinate"]["sp"]
        assert reading["staging"] == {"gloo cpu": False, "gloo cuda:0": True, "nccl cpu": False, "nccl cuda:0": False}
        for dtype_name, dtype in (("torch.bfloat16", torch.bfloat16), ("torch.float32", torch.float32)):
            for direction, offset in ((1, 0), (-1, 2)):
                source = (here - direction) % WORLD
                block = (torch.arange(24, dtype=torch.float32) / 7 + source).to(dtype).reshape(2, 3, 4)
                got = reading["got"][dtype_name]
                np.testing.assert_array_equal(got[offset], block.float().numpy())
                np.testing.assert_array_equal(got[offset + 1], -block[0].float().numpy())


def test_make_mesh_refuses_what_the_job_cannot_hold(pool):
    """A mesh needing more ranks than the job has, and nccl on the CPU, raise: nothing
    shrinks a mesh or moves a rank."""
    for said in pool.run(ranks.mesh_refusals):
        assert "needs 8 ranks, the job has 4" in said["too many ranks"]
        assert "gloo" in said["nccl on the cpu"]
