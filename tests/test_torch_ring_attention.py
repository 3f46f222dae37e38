"""The port's ring attention against the JAX package's under ``shard_map``: four spawned
gloo ranks hold one sequence shard each and run the einsum ring (``ring_attention``) and
the kernel ring (``ring_flash_attention``, its flash forward on the plain version here,
as the JAX ring runs its Pallas kernel in interpret mode), causal or not, in fp32 and
bf16; outputs and the gradients of sum(out * w) are held to JAX's, and to plain
whole-sequence attention."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from hivemind_tpu.parallel import make_mesh as jax_make_mesh
from hivemind_tpu.parallel._compat import NO_CHECK, shard_map
from hivemind_tpu.parallel.ring_attention import plain_attention as jax_plain_attention
from hivemind_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from hivemind_tpu.parallel.ring_attention import ring_flash_attention as jax_ring_flash_attention

import torch_mesh_ranks as ranks

SP = 4
SHAPE = (2, 64, 2, 16)  # [B, T, H, D]: 16 positions a shard
# fp32: both rings sum the same terms in other orders, so outputs and gradients agree
# within fp32 rounding of O(T) terms; bf16: each ring rounds its probabilities, running
# sums and accumulator to bf16 (u = 2^-8) step by step in its own order, so the two
# differ by a few units of bf16 rounding, relative to each value and to the values' scale
# (1: the inputs are standard normal)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=4 * 2.0**-8, atol=4 * 2.0**-8)}


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(SP)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(*SHAPE).astype(np.float32) for _ in range(3))
    return q, k, v, np.cos(np.arange(np.prod(SHAPE))).reshape(SHAPE).astype(np.float32)


def _jax_ring(q, k, v, w, causal, dtype, flash):
    mesh = jax_make_mesh(1, 1, SP, devices=jax.devices()[:SP])
    spec = PartitionSpec(None, "sp", None, None)
    if flash:
        core = partial(jax_ring_flash_attention, axis_name="sp", interpret=True, causal=causal)
        extra = NO_CHECK
    else:
        core, extra = partial(jax_ring_attention, axis_name="sp", causal=causal), {}
    ring = shard_map(core, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, **extra)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    loss = lambda q, k, v: jnp.sum(ring(q, k, v).astype(jnp.float32) * w)
    with mesh:
        out = jax.jit(ring)(*args)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def _assemble(readings, key, index=None):
    shards = sorted(readings, key=lambda r: r["coordinate"]["sp"])
    return np.concatenate([r[key] if index is None else r[key][index] for r in shards], axis=1)


@pytest.mark.parametrize("flash", [False, True], ids=["einsum_ring", "flash_ring"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_ring_matches_the_jax_ring(pool, inputs, flash, causal, dtype_name):
    """Outputs and gradients of the port's ring on four gloo ranks within ``TOL`` of the
    JAX ring's on a four-device mesh; the output keeps the input dtype; in fp32 both are
    within 1e-4 of plain whole-sequence attention. On CPU tensors the kernel ring runs
    the plain version of the flash forward, which counts no launch."""
    q, k, v, w = inputs
    readings = pool.run(ranks.ring_attention_shards, (1, 1, SP), q, k, v, w, causal, dtype_name, flash)
    dtype = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    expected_out, expected_grads = _jax_ring(q, k, v, w, causal, dtype, flash)
    np.testing.assert_allclose(_assemble(readings, "out"), expected_out, **TOL[dtype_name])
    for index, name in enumerate("qkv"):
        np.testing.assert_allclose(_assemble(readings, "grads", index), expected_grads[index], **TOL[dtype_name],
                                   err_msg=f"d{name}")
    assert all(r["dtype"] == f"torch.{dtype_name}" and r["launches"] == 0 for r in readings)
    if dtype_name == "float32":
        plain = np.asarray(jax_plain_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal))
        np.testing.assert_allclose(_assemble(readings, "out"), plain, rtol=0, atol=1e-4)
