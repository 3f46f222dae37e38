"""PyTorch port vs JAX package: the training slice on the CPU (``device="cpu"``).

ALBERT MLM at ``AlbertConfig.tiny(dtype=float32)``: the loss and every gradient,
one AdamW step against ``optax.adamw``, and remat; then ``ModuleBackend.backward``
on the expert blocks against the JAX backend with SGD. Both packages get the same
weights (the flax params carried across with ``hivemind_tpu_torch.convert``) and
the same batches, built with numpy. ALBERT runs in fp32 on both sides, so the
point is the algorithm; the expert blocks compute in bf16 on both sides, so their
limits are bf16-sized. Each test states its limit and the gap measured on these
seeds."""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hivemind_tpu.models.albert import AlbertConfig as JaxAlbertConfig
from hivemind_tpu.models.albert import AlbertForMaskedLM as JaxAlbertForMaskedLM
from hivemind_tpu.models.albert import make_mlm_loss_fn as jax_make_mlm_loss_fn
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu_torch.convert import from_flax_albert_params, from_flax_params, to_flax_params
from hivemind_tpu_torch.models import (
    AlbertConfig,
    AlbertForMaskedLM,
    make_mlm_loss_fn,
    make_synthetic_mlm_batch,
    make_train_step,
)
from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.module_backend import ModuleBackend

# the shapes are tiny: one intra-op thread is enough, and it leaves the cores to
# the timing-sensitive swarm tests that share the machine with this file
torch.set_num_threads(1)

BATCH, SEQ = 2, 64
# fp32 on both sides; only the order of sums differs. Measured on these seeds:
# loss <= 1.3e-7 relative, gradients' error norm over reference norm <= 7.6e-7.
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-5
# one AdamW step moves each parameter by about lr·sign(g) + lr·wd·p; the deltas
# are held to an absolute limit of 2e-2·lr (measured: <= 6.5e-7, i.e. 6.5e-3·lr,
# at elements whose gradient is near Adam's eps, where g/(|g| + eps) is steep)
ADAMW_LR = 1e-4
ADAMW_DELTA_ATOL = 2e-2 * ADAMW_LR
# expert blocks compute in bf16 on both sides: the input gradient's and the SGD
# step's largest error over the reference's largest magnitude. Measured: input
# gradients <= 8.9e-3, parameter steps <= 1.67e-2 (biases, whose gradients sum
# bf16 terms over every position).
BACKWARD_MAX_REL_ERR = 2.5e-2
SGD_LR = 1e-2
# The key projection's bias shifts every score of a query row by the same amount,
# which softmax ignores: its exact gradient is 0 and what both packages compute
# is rounding noise, so it is held to a bound instead of to the other side.
# Measured: fp32 ALBERT <= 4.0e-9 against a largest gradient of 0.41 (bound 1e-6
# of the largest); bf16 blocks <= 0.3% of the largest step (bound 1%).
ZERO_GRADIENT = "key.bias"


def _max_rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_flax_params(params, rng):
    """Replace every leaf, so no zero bias or unit scale hides a wrong mapping:
    kernels ~ N(0, 1/fan_in), embeddings ~ N(0, 1/width), norm scales near 1,
    biases and position embeddings small."""

    def leaf(path, value):
        name = path[-1].key
        shape = np.shape(value)
        if name == "kernel":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[0]), np.float32)
        if name == "embedding":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[1]), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _numpy_mlm_batch(rng, vocab_size: int) -> dict:
    labels = rng.randint(0, vocab_size, size=(BATCH, SEQ)).astype(np.int32)
    mlm_mask = rng.rand(BATCH, SEQ) < 0.15
    mlm_mask[:, 0] = True  # every row has a masked position
    input_ids = np.where(mlm_mask, vocab_size - 1, labels).astype(np.int32)
    return {"input_ids": input_ids, "labels": labels, "mlm_mask": mlm_mask}


def _albert_case(seed: int):
    """(flax params, numpy batch, JAX tiny model) at AlbertConfig.tiny(float32)."""
    rng = np.random.RandomState(seed)
    jax_model = JaxAlbertForMaskedLM(JaxAlbertConfig.tiny(dtype=jnp.float32))
    batch = _numpy_mlm_batch(rng, JaxAlbertConfig.tiny().vocab_size)
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(batch["input_ids"][:1, :8]))["params"]
    return _random_flax_params(params, rng), batch, jax_model


def _port_model(params, **overrides) -> AlbertForMaskedLM:
    model = AlbertForMaskedLM(AlbertConfig.tiny(dtype=torch.float32, **overrides))
    model.load_state_dict(from_flax_albert_params(params))
    return model


def _torch_batch(batch: dict) -> dict:
    return {key: torch.from_numpy(np.array(value)) for key, value in batch.items()}


def _port_loss_and_grads(model, batch, fraction):
    loss = make_mlm_loss_fn(model, fraction)(_torch_batch(batch))
    model.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), {name: p.grad.clone() for name, p in model.named_parameters()}


# ------------------------------------------------------------------ ALBERT


@pytest.mark.parametrize("fraction", [None, 0.25], ids=["full_logits", "masked_only"])
def test_albert_loss_and_every_gradient_match_jax(fraction):
    params, batch, jax_model = _albert_case(seed=0)
    jax_loss, jax_grads = jax.value_and_grad(jax_make_mlm_loss_fn(jax_model, fraction))(
        params, {key: jnp.asarray(value) for key, value in batch.items()})
    model = _port_model(params)
    assert set(model.state_dict()) == set(from_flax_albert_params(params))
    loss, grads = _port_loss_and_grads(model, batch, fraction)
    assert abs(loss - float(jax_loss)) <= LOSS_RTOL * abs(float(jax_loss))
    expected = from_flax_albert_params(jax_grads)
    assert set(grads) == set(expected)
    largest = max(g.abs().max().item() for g in grads.values())
    for name, grad in grads.items():
        assert grad.shape == expected[name].shape, name
        if name.endswith(ZERO_GRADIENT):
            assert max(grad.abs().max().item(), np.abs(expected[name].numpy()).max()) <= 1e-6 * largest
        else:
            assert _rel_l2(grad.numpy(), expected[name].numpy()) <= GRAD_REL_L2, name


def test_albert_adamw_step_matches_optax_adamw():
    """torch's AdamW with optax's weight decay (1e-4; torch's default is 1e-2)."""
    params, batch, jax_model = _albert_case(seed=1)
    grads = jax.grad(jax_make_mlm_loss_fn(jax_model, 0.25))(params, {key: jnp.asarray(v) for key, v in batch.items()})
    optimizer = optax.adamw(ADAMW_LR)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    expected = from_flax_albert_params(updates)

    model = _port_model(params)
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    adamw = torch.optim.AdamW(model.parameters(), lr=ADAMW_LR, weight_decay=1e-4)
    _port_loss_and_grads(model, batch, 0.25)
    adamw.step()
    moved = 0
    for name, p in model.named_parameters():
        delta = (p.detach() - before[name]).numpy()
        if name.endswith(ZERO_GRADIENT):  # the sign of noise: any step of at most lr, plus the decay
            decay = -ADAMW_LR * 1e-4 * before[name].numpy()
            assert np.abs(delta - decay).max() <= ADAMW_LR * (1 + 1e-6)
        else:
            np.testing.assert_allclose(delta, expected[name].numpy(), rtol=0, atol=ADAMW_DELTA_ATOL, err_msg=name)
        moved += int(np.abs(delta).max() > 0.5 * ADAMW_LR)
    assert moved >= len(before) - 1  # every parameter took a step of about lr (key.bias: of its noise)

    torch_default = torch.optim.AdamW([torch.zeros(1)], lr=ADAMW_LR)
    assert torch_default.defaults["weight_decay"] == 1e-2  # the trap the factory avoids


def test_albert_remat_gives_the_same_loss_and_gradients():
    """Recomputing each shared-layer application changes no value on the CPU:
    loss and gradients are compared exactly (measured: bit-identical)."""
    params, batch, _ = _albert_case(seed=2)
    plain = _port_loss_and_grads(_port_model(params), batch, 0.25)
    remat_model = _port_model(params, remat=True)
    assert list(remat_model.state_dict()) == list(_port_model(params).state_dict())
    remat = _port_loss_and_grads(remat_model, batch, 0.25)
    assert remat[0] == plain[0]
    for name, grad in plain[1].items():
        torch.testing.assert_close(remat[1][name], grad, rtol=0, atol=0, msg=name)


def test_albert_train_step_trains_on_synthetic_batches():
    """make_train_step on the CPU: finite, falling loss over a few AdamW steps on
    one synthetic batch; the batch keeps the JAX package's distribution."""
    config = AlbertConfig.tiny()
    model, train_step = make_train_step(config, lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-4),
                                        masked_loss_fraction=0.25, device="cpu")
    assert next(model.parameters()).dtype == torch.float32 and config.dtype == torch.bfloat16
    batch = make_synthetic_mlm_batch(torch.Generator().manual_seed(0), config, 4, 128)
    masked = batch["mlm_mask"]
    assert 0.08 < masked.float().mean().item() < 0.22
    assert torch.equal(batch["input_ids"][masked], torch.full_like(batch["input_ids"][masked], config.vocab_size - 1))
    assert torch.equal(batch["input_ids"][~masked], batch["labels"][~masked])
    losses = [train_step(batch).item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        AlbertForMaskedLM(AlbertConfig.tiny(mesh=object()), device="cpu").encode(batch["input_ids"])


# ------------------------------------------------------------------ ModuleBackend.backward

BACKWARD_CASES = [
    ("ffn", {}, (3, 32)),
    ("transformer", {"num_heads": 4}, (2, 16, 32)),
    ("causal_transformer", {"num_heads": 4}, (2, 16, 32)),
    ("llama_block", {"num_heads": 4}, (2, 16, 64)),
]


@pytest.mark.parametrize("block,kwargs,shape", BACKWARD_CASES, ids=[case[0] for case in BACKWARD_CASES])
def test_module_backend_backward_matches_jax(block, kwargs, shape):
    rng = np.random.RandomState(len(block) + 7)
    x = rng.randn(*shape).astype(np.float32)
    grad_out = rng.randn(*shape).astype(np.float32)
    hid = shape[-1]
    jax_backend = JaxModuleBackend("jax", jax_blocks[block](hid, **kwargs), optimizer=optax.sgd(SGD_LR), sample_input=x)
    flax_params = _random_flax_params(jax_backend.params, rng)
    jax_backend.load_params(flax_params)
    backend = ModuleBackend("torch", name_to_block[block](hid, **kwargs), sample_input=x, device="cpu",
                            optimizer=lambda tensors: torch.optim.SGD(tensors, lr=SGD_LR))
    backend.load_params(from_flax_params(block, flax_params))
    assert backend.get_info()["updates"] == 0

    expected = jax_backend.backward(x, grad_out)[0]
    got = backend.backward(x, grad_out)[0]
    assert got.dtype == np.float32 and got.shape == x.shape
    assert _max_rel_err(got, expected) < BACKWARD_MAX_REL_ERR
    ours, theirs = to_flax_params(block, backend.snapshot_params()), jax_backend.params
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    steps = {}
    for (path, start), new, reference in zip(jax.tree_util.tree_leaves_with_path(flax_params),
                                             jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        steps[".".join(key.key for key in path)] = (new - start, np.asarray(reference) - start)
    largest = max(np.abs(expected_step).max() for _, expected_step in steps.values())
    for name, (step, expected_step) in steps.items():
        if name == ZERO_GRADIENT:
            assert max(np.abs(step).max(), np.abs(expected_step).max()) <= 1e-2 * largest
        else:
            assert np.abs(expected_step).max() > 0, name
            assert _max_rel_err(step, expected_step) < BACKWARD_MAX_REL_ERR, name
    assert backend.update_count == jax_backend.update_count == 1
    assert backend.get_info()["updates"] == jax_backend.get_info()["updates"] == 1


def test_module_backend_decays_an_unused_parameter_as_optax_adamw():
    """An unused parameter gets a zero gradient, not None: AdamW then decays it,
    as optax.adamw does on the JAX backend (a None would make torch skip it)."""

    class JaxUnused(flax_nn.Module):
        @flax_nn.compact
        def __call__(self, x):
            self.param("unused", flax_nn.initializers.ones, (4,))
            return flax_nn.Dense(4, use_bias=False)(x)

    class Unused(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = torch.nn.Linear(4, 4, bias=False)
            self.unused = torch.nn.Parameter(torch.ones(4))

        def forward(self, x):
            return self.Dense_0(x)

    rng = np.random.RandomState(11)
    x, grad_out = (rng.randn(3, 4).astype(np.float32) for _ in range(2))
    # lr 1: one step decays a parameter by lr·wd = 1e-4 of itself, far above the limit
    lr, weight_decay = 1.0, 1e-4
    jax_backend = JaxModuleBackend("jax", JaxUnused(), optimizer=optax.adamw(lr, weight_decay=weight_decay),
                                   sample_input=x)
    params = {"Dense_0": {"kernel": rng.randn(4, 4).astype(np.float32)}, "unused": 1.0 + rng.rand(4).astype(np.float32)}
    jax_backend.load_params(params)
    backend = ModuleBackend("torch", Unused(), sample_input=x, device="cpu",
                            params={"Dense_0.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
                                    "unused": torch.from_numpy(params["unused"])},
                            optimizer=lambda tensors: torch.optim.AdamW(tensors, lr=lr, weight_decay=weight_decay))
    jax_backend.backward(x, grad_out)
    backend.backward(x, grad_out)
    expected = np.asarray(jax_backend.params["unused"])
    got = backend.snapshot_params()["unused"].numpy()
    np.testing.assert_allclose(expected, params["unused"] * (1 - lr * weight_decay), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-6)
    assert np.abs(got - params["unused"]).min() > 50e-6  # decayed, not skipped
    np.testing.assert_allclose(backend.snapshot_params()["Dense_0.weight"].numpy().T,
                               np.asarray(jax_backend.params["Dense_0"]["kernel"]), rtol=0, atol=1e-5)
