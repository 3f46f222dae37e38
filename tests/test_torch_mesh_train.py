"""The port's ALBERT train step on a mesh against the JAX package's: tiny ALBERT (fp32)
on four spawned gloo ranks at ``(dp, tp, sp)`` = (1, 2, 2) and (2, 1, 2) — tensor-parallel
leaves, the batch sharded ``[dp, sp]``, ring attention over ``sp``, gradients reduced
over ``dp`` — takes one SGD step from the JAX model's weights on the JAX package's batch,
and the loss and every updated parameter are held to JAX's ``make_train_step`` on its
``make_mesh`` of four devices."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from hivemind_tpu.models import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models import make_train_step as jax_make_train_step
from hivemind_tpu.parallel import make_mesh as jax_make_mesh
from hivemind_tpu.parallel import params_shardings as jax_params_shardings

import torch_mesh_ranks as ranks

WORLD, BATCH, SEQ, LR = 4, 4, 32, 0.1
# fp32 on both sides: the sharded sums (tensor-parallel partial products, ring steps,
# gradient reductions) run in other orders than XLA's, so each value differs by fp32
# rounding of its terms: 2e-5 of the loss, and each parameter's change within 1e-5 of
# the leaf's largest change (1e-9 absolute for the key bias, whose gradient is 0), plus
# one fp32 ulp of the leaf's largest value for the rounding of p - lr * g itself
LOSS_RTOL, STEP_RTOL, ULP = 2e-5, 1e-5, 2.0**-23


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(WORLD)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def weights_and_batch():
    config = JaxAlbertConfig.tiny(dtype=jnp.float32, max_position=SEQ)
    model, _ = jax_make_train_step(config, optax.sgd(LR))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(5)
    labels = rng.randint(0, config.vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    mlm_mask = rng.rand(BATCH, SEQ) < 0.4  # often above the 0.25 budget: rows are truncated across shards
    input_ids = np.where(mlm_mask, config.vocab_size - 1, labels).astype(np.int32)
    return params, {"input_ids": input_ids, "labels": labels, "mlm_mask": mlm_mask}


def _jax_step(shape, params, batch, fraction):
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:WORLD])
    config = JaxAlbertConfig.tiny(dtype=jnp.float32, max_position=SEQ, mesh=mesh)
    _, train_step = jax_make_train_step(config, optax.sgd(LR), masked_loss_fraction=fraction)
    sharded = jax.device_put(params, jax_params_shardings(params, mesh))
    with mesh:
        loss, new_params, _ = jax.jit(train_step)(sharded, optax.sgd(LR).init(sharded),
                                                   jax.device_put(batch, NamedSharding(mesh, PartitionSpec("dp", "sp"))))
    flat = jax.tree_util.tree_flatten_with_path(new_params)[0]
    return float(loss), {"/".join(str(e.key) for e in path): np.asarray(value) for path, value in flat}


@pytest.mark.parametrize("fraction", [0.25, None], ids=["masked_only", "full_logits"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=["1x2x2", "2x1x2"])
def test_mesh_train_step_matches_the_jax_mesh(pool, weights_and_batch, shape, fraction):
    params, batch = weights_and_batch
    readings = pool.run(ranks.albert_train_step, shape, params, batch, fraction, LR, SEQ)
    loss, expected = _jax_step(shape, params, batch, fraction)
    assert all(abs(r["loss"] - loss) <= LOSS_RTOL * abs(loss) for r in readings), ([r["loss"] for r in readings], loss)
    got = readings[0]["params"]
    assert sorted(got) == sorted(expected)
    before = {"/".join(str(e.key) for e in path): value for path, value in jax.tree_util.tree_flatten_with_path(params)[0]}
    for path, value in expected.items():
        change = np.abs(value - before[path]).max()
        limit = (1e-9 if path.endswith("key/bias") else STEP_RTOL * change) + ULP * np.abs(value).max()
        assert np.abs(got[path] - value).max() <= limit, (path, np.abs(got[path] - value).max(), change)
    tp = shape[1]
    local = readings[0]["local_shapes"]
    assert local["shared_layer.query.weight"][0] * tp == local["shared_layer.query.weight"][1]  # its heads only
    assert local["shared_layer.ffn_down.weight"][1] * tp == 128  # its ffn units only
