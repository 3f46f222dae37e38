"""PyTorch port vs JAX package: the causal LM (``models/causal_lm.py``) on the CPU.

``CausalLMConfig.tiny(dtype=float32)`` on both sides, the same weights (the flax params
carried across with ``hivemind_tpu_torch.convert``) and the same numpy batch: the loss and
every gradient, one Adam and one AdamW step against optax's, remat, learning, the flax
tree, one SGD step on four gloo ranks against JAX's ``make_mesh`` step, and the trainer's
``--model causal``.

Tolerances: fp32 on both sides, so only the order of sums differs. The loss within 1e-5
relative and each gradient's error norm over its norm within 1e-5 (measured: 1.3e-7 and
1.1e-6). An Adam step moves each parameter by about lr·g/(|g| + eps): the steps are held
to 2e-2·lr absolute (``tests/test_torch_training.py``'s limit; measured 2.3e-3·lr, at
elements whose gradient is near eps). The key bias's exact gradient is 0 (softmax ignores
a shift of a query row's scores): it is held to 1e-6 of the largest gradient, and its Adam
step, the sign of noise, to lr. The mesh step: ``tests/test_torch_mesh_train.py``'s limits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from hivemind_tpu.models import CausalLM as JaxCausalLM
from hivemind_tpu.models import CausalLMConfig as JaxCausalLMConfig
from hivemind_tpu.models import causal_lm_loss as jax_causal_lm_loss
from hivemind_tpu.models import make_causal_train_step as jax_make_causal_train_step
from hivemind_tpu.parallel import make_mesh as jax_make_mesh
from hivemind_tpu.parallel import params_shardings as jax_params_shardings
from hivemind_tpu_torch.convert import from_flax_albert_params, to_flax_tree
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.examples.albert import run_trainer
from hivemind_tpu_torch.models import (
    CausalLM,
    CausalLMConfig,
    causal_lm_loss,
    make_causal_train_step,
    make_synthetic_lm_batch,
)

import torch_mesh_ranks as ranks

torch.set_num_threads(1)  # tiny shapes; leave the cores to the timing-sensitive swarm tests

BATCH, SEQ = 2, 64
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
ADAM_LR = 1e-4
ADAM_DELTA_ATOL = 2e-2 * ADAM_LR
ZERO_GRADIENT = "key.bias"
# the mesh step: tests/test_torch_mesh_train.py's limits
WORLD, MESH_BATCH, MESH_SEQ, MESH_LR = 4, 4, 32, 0.1
MESH_LOSS_RTOL, MESH_STEP_RTOL, ULP = 2e-5, 1e-5, 2.0**-23


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_flax_params(params, rng):
    """Replace every leaf, so no zero bias or unit scale hides a wrong mapping."""

    def leaf(path, value):
        name, shape = path[-1].key, np.shape(value)
        if name == "kernel":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[0]), np.float32)
        if name == "embedding":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[1]), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _case(seed: int, seq: int = SEQ, batch: int = BATCH):
    """(flax params, numpy input_ids, JAX tiny model) at CausalLMConfig.tiny(float32)."""
    rng = np.random.RandomState(seed)
    config = JaxCausalLMConfig.tiny(dtype=jnp.float32)
    jax_model = JaxCausalLM(config)
    input_ids = rng.randint(0, config.vocab_size, size=(batch, seq)).astype(np.int32)
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(input_ids[:1, :8]))["params"]
    return _random_flax_params(params, rng), input_ids, jax_model


def _jax_loss_fn(jax_model):
    return lambda params, ids: jax_causal_lm_loss(jax_model.apply({"params": params}, ids), ids)


def _port_model(params, **overrides) -> CausalLM:
    model = CausalLM(CausalLMConfig.tiny(dtype=torch.float32, **overrides))
    model.load_state_dict(from_flax_albert_params(params))
    return model


def _port_loss_and_grads(model, input_ids):
    ids = torch.from_numpy(np.array(input_ids))
    loss = causal_lm_loss(model(ids), ids)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {name: p.grad.clone() for name, p in model.named_parameters()}


def test_loss_and_every_gradient_match_jax():
    params, input_ids, jax_model = _case(seed=0)
    jax_loss, jax_grads = jax.value_and_grad(_jax_loss_fn(jax_model))(params, jnp.asarray(input_ids))
    model = _port_model(params)
    loss, grads = _port_loss_and_grads(model, input_ids)
    assert abs(loss - float(jax_loss)) <= LOSS_RTOL * abs(float(jax_loss))
    expected = from_flax_albert_params(jax_grads)
    assert set(grads) == set(expected) and len(grads) == 4 + 2 * 16  # embeddings, final norm, 2 layers of 16
    largest = max(g.abs().max().item() for g in grads.values())
    for name, grad in grads.items():
        assert grad.shape == expected[name].shape, name
        if name.endswith(ZERO_GRADIENT):
            assert max(grad.abs().max().item(), np.abs(expected[name].numpy()).max()) <= 1e-6 * largest
        else:
            assert _rel_l2(grad.numpy(), expected[name].numpy()) <= GRAD_REL_L2, name
    # the logits themselves, and the loss's shift: position t predicts token t+1
    ids = torch.from_numpy(input_ids)
    logits = model(ids).detach()
    jax_logits = np.asarray(jax_model.apply({"params": params}, jnp.asarray(input_ids)))
    assert logits.dtype == torch.float32 and _rel_l2(logits.numpy(), jax_logits) <= LOSS_RTOL
    by_hand = -torch.log_softmax(logits[:, :-1], -1).gather(-1, ids[:, 1:, None].long()).mean()
    assert abs(causal_lm_loss(logits, ids).item() - by_hand.item()) <= 1e-6 * abs(by_hand.item())


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_one_adam_step_matches_optax(kind):
    """torch's Adam and AdamW (with optax's weight decay 1e-4) against optax.adam and
    optax.adamw, from the same weights and gradients."""
    params, input_ids, jax_model = _case(seed=1)
    grads = jax.grad(_jax_loss_fn(jax_model))(params, jnp.asarray(input_ids))
    optimizer = optax.adam(ADAM_LR) if kind == "adam" else optax.adamw(ADAM_LR, weight_decay=1e-4)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    expected = from_flax_albert_params(updates)

    model = _port_model(params)
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    if kind == "adam":
        step, decay = torch.optim.Adam(model.parameters(), lr=ADAM_LR), 0.0
    else:
        step, decay = torch.optim.AdamW(model.parameters(), lr=ADAM_LR, weight_decay=1e-4), 1e-4
    _port_loss_and_grads(model, input_ids)
    step.step()
    moved = 0
    for name, p in model.named_parameters():
        delta = (p.detach() - before[name]).numpy()
        if name.endswith(ZERO_GRADIENT):  # the sign of noise: any step of at most lr, plus the decay
            assert np.abs(delta + ADAM_LR * decay * before[name].numpy()).max() <= ADAM_LR * (1 + 1e-6)
            continue
        np.testing.assert_allclose(delta, expected[name].numpy(), rtol=0, atol=ADAM_DELTA_ATOL, err_msg=name)
        moved += int(np.abs(delta).max() > 0.5 * ADAM_LR)
    assert moved == len(before) - 2  # every parameter but the two key biases took a step of about lr


def test_remat_gives_the_same_loss_and_gradients():
    """Recomputing each layer changes no value on the CPU: compared exactly."""
    params, input_ids, _ = _case(seed=2)
    plain = _port_loss_and_grads(_port_model(params), input_ids)
    remat_model = _port_model(params, remat=True)
    assert list(remat_model.state_dict()) == list(_port_model(params).state_dict())
    remat = _port_loss_and_grads(remat_model, input_ids)
    assert remat[0] == plain[0]
    for name, grad in plain[1].items():
        torch.testing.assert_close(remat[1][name], grad, rtol=0, atol=0, msg=name)


def test_the_train_step_learns_one_batch():
    """The JAX package's rule (tests/test_models_parallel.py): 25 steps of Adam(1e-3) on
    one synthetic batch bring the loss under 0.8 of the first, bf16 compute as shipped."""
    config = CausalLMConfig.tiny()
    model, train_step = make_causal_train_step(config, lambda p: torch.optim.Adam(p, lr=1e-3), device="cpu")
    assert next(model.parameters()).dtype == torch.float32 and config.dtype == torch.bfloat16
    batch = make_synthetic_lm_batch(torch.Generator().manual_seed(0), config, 4, 32)
    assert batch["input_ids"].shape == (4, 32) and 0 <= batch["input_ids"].min() <= batch["input_ids"].max() < 1024
    losses = [train_step(batch).item() for _ in range(25)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses


def test_the_flax_tree_is_the_jax_models():
    """``to_flax_tree`` of the port's state_dict has exactly the JAX model's paths and
    shapes, and the weights carry across both ways."""
    config = JaxCausalLMConfig.tiny()
    params = JaxCausalLM(config).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = CausalLM(CausalLMConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    tree = to_flax_tree(model.state_dict())
    paths = lambda t: {tuple(str(e.key) for e in path): np.shape(leaf) for path, leaf in
                       jax.tree_util.tree_flatten_with_path(t)[0]}
    assert paths(tree) == paths(params)
    randomized = _random_flax_params(params, np.random.RandomState(4))
    model.load_state_dict(from_flax_albert_params(randomized))
    back = to_flax_tree(model.state_dict())
    for (path, leaf), (_, theirs) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                         jax.tree_util.tree_flatten_with_path(randomized)[0]):
        np.testing.assert_array_equal(leaf, theirs, err_msg=str(path))
    # the initializers' distributions: position embeddings N(0, 0.02²), norms 1, biases 0
    state = CausalLM(CausalLMConfig.tiny())
    state.reset_parameters(torch.Generator().manual_seed(1))
    assert abs(state.position_embeddings.std().item() - 0.02) < 2e-3
    assert torch.equal(state.final_norm.weight, torch.ones(64)) and not state.layer_1.ffn_up.bias.any()


# ------------------------------------------------------------------ on a mesh


@pytest.fixture(scope="module")
def pool():
    pool = ranks.RankPool(WORLD)
    yield pool
    pool.close()


def _jax_mesh_step(shape, params, input_ids):
    mesh = jax_make_mesh(*shape, devices=jax.devices()[:WORLD])
    config = JaxCausalLMConfig.tiny(dtype=jnp.float32, mesh=mesh)
    _, train_step = jax_make_causal_train_step(config, optax.sgd(MESH_LR))
    sharded = jax.device_put(params, jax_params_shardings(params, mesh))
    batch = {"input_ids": jax.device_put(input_ids, NamedSharding(mesh, PartitionSpec("dp", "sp")))}
    with mesh:
        loss, new_params, _ = jax.jit(train_step)(sharded, optax.sgd(MESH_LR).init(sharded), batch)
    flat = jax.tree_util.tree_flatten_with_path(new_params)[0]
    return float(loss), {"/".join(str(e.key) for e in path): np.asarray(value) for path, value in flat}


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=["1x2x2", "2x1x2"])
def test_mesh_train_step_matches_the_jax_mesh(pool, shape):
    """One SGD step on four gloo ranks: tensor-parallel leaves, the batch sharded
    ``[dp, sp]``, causal ring attention over ``sp`` and the loss's shift across the
    ``sp`` shards, held to JAX's jitted step on its mesh of four devices."""
    params, input_ids, _ = _case(seed=3, seq=MESH_SEQ, batch=MESH_BATCH)
    readings = pool.run(ranks.causal_lm_train_step, shape, params, input_ids, MESH_LR)
    loss, expected = _jax_mesh_step(shape, params, input_ids)
    assert all(abs(r["loss"] - loss) <= MESH_LOSS_RTOL * abs(loss) for r in readings), ([r["loss"] for r in readings], loss)
    got = readings[0]["params"]
    assert sorted(got) == sorted(expected)
    before = {"/".join(str(e.key) for e in path): value for path, value in jax.tree_util.tree_flatten_with_path(params)[0]}
    for path, value in expected.items():
        change = np.abs(value - before[path]).max()
        limit = (1e-9 if path.endswith("key/bias") else MESH_STEP_RTOL * change) + ULP * np.abs(value).max()
        assert np.abs(got[path] - value).max() <= limit, (path, np.abs(got[path] - value).max(), change)
    tp = shape[1]
    local = readings[0]["local_shapes"]
    assert local["layer_0.query.weight"][0] * tp == local["layer_0.query.weight"][1]  # its heads only
    assert local["layer_1.ffn_down.weight"][1] * tp == 128  # its ffn units only
    assert local["word_embeddings.weight"] == (1024, 64) and local["position_embeddings"] == (128, 64)


# ------------------------------------------------------------------ the trainer


def test_the_trainer_trains_the_causal_lm_on_the_cpu():
    """``run_trainer --model causal --tiny --device cpu``: a swarm of one trains the tiny
    causal LM on the sampler's unmasked token stream through the collaborative Optimizer."""
    bootstrap = DHT(start=True)
    try:
        opt = run_trainer.main([
            "--model", "causal", "--tiny", "--device", "cpu", "--run_id", "causal_cpu",
            "--initial_peers", *[str(m) for m in bootstrap.get_visible_maddrs()], "--max_steps", "6",
            "--target_batch_size", "8", "--batch_size", "4", "--seq_len", "32", "--seed", "1",
            "--warmup_epochs", "2", "--matchmaking_time", "0.5"])
    finally:
        bootstrap.shutdown()
    assert opt.local_epoch >= 2
    names = set(opt.params)
    assert "position_embeddings" in names and "layer_1.ffn_down.weight" in names and "mlm_bias" not in names
    assert all(torch.isfinite(p).all() for p in opt.params.values())
