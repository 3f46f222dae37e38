"""PyTorch port vs JAX package: KV-cache decode steps of the decoder blocks,
``DecodeSessionManager`` (sessions, eviction, continuous batching), and greedy
generation through ``LlamaClientHead``/``generate_greedy``, on the CPU.

Both packages get the same weights (``from_flax_params``) and compute dense layers
in bf16, so the two sides agree within a bf16 tolerance: the largest absolute
difference over the reference's largest magnitude, as ops/device_check.py
measures it. The port is held to its own no-cache forward exactly, as the JAX
package's ``tests/test_moe.py::test_decode_cache_matches_full_forward`` holds the
JAX blocks to theirs."""

import asyncio
import json
import threading
import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from safetensors.numpy import save_file

from hivemind_tpu.moe.server.decode_session import DecodeSessionManager as JaxDecodeSessionManager
from hivemind_tpu.moe.server.layers import name_to_block as jax_blocks
from hivemind_tpu.moe.server.layers.common import apply_rope as jax_apply_rope
from hivemind_tpu.moe.server.llama_loader import LlamaClientHead as JaxLlamaClientHead
from hivemind_tpu.moe.server.llama_loader import LlamaCheckpointConfig as JaxLlamaCheckpointConfig
from hivemind_tpu.moe.server.llama_loader import decode_cache_bytes as jax_decode_cache_bytes
from hivemind_tpu.moe.server.llama_loader import load_llama_blocks as jax_load_llama_blocks
from hivemind_tpu.moe.server.module_backend import ModuleBackend as JaxModuleBackend
from hivemind_tpu_torch.convert import from_flax_params
from hivemind_tpu_torch.moe.server import (
    DecodeSessionManager,
    LlamaClientHead,
    ModuleBackend,
    decode_cache_bytes,
    generate_greedy,
    load_llama_blocks,
)
from hivemind_tpu_torch.moe.server.layers import name_to_block
from hivemind_tpu_torch.moe.server.layers.common import apply_rope
from hivemind_tpu_torch.moe.server.llama_loader import LlamaCheckpointConfig

# the shapes are tiny: one intra-op thread is enough, and it leaves the cores to
# the timing-sensitive swarm tests that share the machine with this file
torch.set_num_threads(1)

HID = 16
DECODER_CASES = [
    ("causal_transformer", {"num_heads": 4}),
    ("llama_block", {"num_heads": 4, "num_kv_heads": 2}),  # grouped-query: compact caches
]
# bf16 compute on both sides: port vs JAX package. Measured over seeds 0-5 of each
# block: session steps <= 9.9e-3, the no-cache forward of the same blocks <= 6.5e-3
# (the JAX package pads a prefill to a power of two and fuses under jit, so the
# two sides round differently; one bf16 ulp is up to 7.8e-3 of a value).
MAX_REL_ERR = 1.5e-2
# a merged step vs the same session decoded alone: fp32 outputs of bf16 blocks,
# held as the JAX package holds its vmapped step (measured: identical)
BATCHED_RTOL = BATCHED_ATOL = 1e-5


def _max_rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _random_flax_params(params, rng):
    """Replace every leaf: kernels ~ N(0, 1/fan_in), norm scales near 1, biases small."""

    def leaf(path, value):
        name, shape = path[-1].key, np.shape(value)
        if name == "kernel":
            return np.asarray(rng.randn(*shape) / np.sqrt(shape[0]), np.float32)
        if name == "scale":
            return np.asarray(1.0 + 0.1 * rng.randn(*shape), np.float32)
        return np.asarray(0.1 * rng.randn(*shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _backends(block, kwargs, seed, uid="dec.0"):
    """The same random weights in a JAX and a port backend (CPU)."""
    rng = np.random.RandomState(seed)
    sample = np.zeros((1, 4, HID), np.float32)
    jax_backend = JaxModuleBackend(uid, jax_blocks[block](HID, **kwargs), optimizer=optax.sgd(0.0), sample_input=sample)
    flax_params = _random_flax_params(jax_backend.params, rng)
    jax_backend.load_params(flax_params)
    backend = ModuleBackend(uid, name_to_block[block](HID, **kwargs), sample_input=sample, device="cpu",
                            params=from_flax_params(block, flax_params))
    return jax_backend, backend


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("block,kwargs", DECODER_CASES, ids=[case[0] for case in DECODER_CASES])
def test_cached_steps_match_jax_and_the_no_cache_forward(block, kwargs):
    jax_backend, backend = _backends(block, kwargs, seed=len(block))
    jax_module, params = jax_backend.module, {"params": jax_backend.params}
    module = name_to_block[block](HID, **kwargs)
    module.load_state_dict(backend.snapshot_params())
    x = np.random.RandomState(0).randn(2, 12, HID).astype(np.float32)

    jax_cache = jax_module.init_decode_cache(batch=2, max_len=32)
    y, *jax_cache = jax_module.apply(params, jnp.asarray(x[:, :5]), *jax_cache, 0)
    jax_steps = [np.asarray(y)]
    for t in range(5, 12):
        y, *jax_cache = jax_module.apply(params, jnp.asarray(x[:, t : t + 1]), *jax_cache, t)
        jax_steps.append(np.asarray(y))
    jax_steps = np.concatenate(jax_steps, axis=1)

    with torch.inference_mode():
        cache_k, cache_v = module.init_decode_cache(2, 32, "cpu")
        kv_heads = kwargs.get("num_kv_heads", kwargs["num_heads"])
        assert cache_k.shape == (2, 32, kv_heads, HID // kwargs["num_heads"]) and cache_k.dtype == torch.bfloat16
        y, cache_k, cache_v = module(torch.from_numpy(x[:, :5]), cache_k, cache_v, 0)
        steps = [y.numpy()]
        for t in range(5, 12):
            y, cache_k, cache_v = module(torch.from_numpy(x[:, t : t + 1]), cache_k, cache_v, t)
            steps.append(y.numpy())
        steps = np.concatenate(steps, axis=1)
        full = module(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(cache_k[:, 12:].float().numpy(), 0)  # nothing written past the last step
        # per-row indices, as the session manager's merged step drives them: row 0
        # continues at position 12, row 1 (cut back to 10 positions) at 10; each
        # row matches its own step with an int index
        stacked = [cache.clone() for cache in (cache_k, cache_v)]
        for cache in stacked:
            cache[1, 10:] = 0
        alone = [module(torch.from_numpy(x[row : row + 1, 11:12]), *(c[row : row + 1].clone() for c in stacked), index)[0]
                 for row, index in ((0, 12), (1, 10))]
        y_rows, rows_k, _ = module(torch.from_numpy(x[:, 11:12]), *stacked, torch.tensor([12, 10]))

    assert steps.shape == full.shape == x.shape and steps.dtype == np.float32
    np.testing.assert_array_equal(steps, full)  # measured: identical
    assert _max_rel_err(steps, jax_steps) < MAX_REL_ERR
    for row in range(2):
        np.testing.assert_array_equal(y_rows[row : row + 1].numpy(), alone[row].numpy())
    assert rows_k[0, 12].abs().sum() > 0 and rows_k[1, 10].abs().sum() > 0 and rows_k[1, 11:].abs().sum() == 0


def test_rope_offset_matches_jax_for_an_int_and_per_row():
    rng = np.random.RandomState(14)
    x = rng.randn(3, 5, 2, 16).astype(np.float32)
    for offset in (0, 7, 1000):
        expected = np.asarray(jax_apply_rope(jnp.asarray(x), 10000.0, offset))
        np.testing.assert_allclose(apply_rope(torch.from_numpy(x), 10000.0, offset).numpy(), expected, rtol=0, atol=2e-4)
    offsets = [3, 0, 511]
    per_row = apply_rope(torch.from_numpy(x), 10000.0, torch.tensor(offsets)).numpy()
    for row, offset in enumerate(offsets):
        expected = np.asarray(jax_apply_rope(jnp.asarray(x[row : row + 1]), 10000.0, jnp.int32(offset)))
        np.testing.assert_allclose(per_row[row : row + 1], expected, rtol=0, atol=2e-4)


# ------------------------------------------------------------------ sessions


@pytest.mark.parametrize("block,kwargs", DECODER_CASES, ids=[case[0] for case in DECODER_CASES])
def test_session_manager_matches_the_jax_manager(block, kwargs):
    jax_backend, backend = _backends(block, kwargs, seed=3 + len(block))
    jax_manager = JaxDecodeSessionManager({"dec.0": jax_backend}, max_len=32)
    manager = DecodeSessionManager({"dec.0": backend}, max_len=32)
    assert manager.supports("dec.0") and not manager.supports("other")
    x = np.random.RandomState(1).randn(1, 9, HID).astype(np.float32)
    for t, chunk in enumerate([x[:, :6]] + [x[:, t : t + 1] for t in range(6, 9)]):
        expected = jax_manager.decode("dec.0", "s", chunk, reset=t == 0)
        got = manager.decode("dec.0", "s", chunk, reset=t == 0)
        assert got.shape == expected.shape == chunk.shape
        assert _max_rel_err(got, expected) < MAX_REL_ERR
    assert manager._sessions[("dec.0", "s")].index == 9


def _decode_backend(uid="lim.0"):
    return {uid: _backends("causal_transformer", {"num_heads": 4}, seed=5, uid=uid)[1]}


def test_session_cap_evicts_the_oldest_session():
    manager = DecodeSessionManager(_decode_backend(), max_len=32, max_sessions=2)
    rng = np.random.RandomState(0)
    for name in ("s1", "s2", "s3"):
        manager.decode("lim.0", name, rng.randn(1, 3, HID).astype(np.float32), reset=True)
        time.sleep(0.002)  # distinct last_used ordering
    # the cap (2) is enforced on the next call's sweep: s1, the oldest, goes
    step = rng.randn(1, 1, HID).astype(np.float32)
    manager.decode("lim.0", "s3", step, reset=False)
    assert set(key[1] for key in manager._sessions) == {"s2", "s3"}
    with pytest.raises(KeyError, match="reset=True"):
        manager.decode("lim.0", "s1", step, reset=False)


def test_session_ttl_eviction_and_reset_semantics():
    manager = DecodeSessionManager(_decode_backend(), max_len=32, max_sessions=8, session_ttl=0.1)
    prompt = np.random.RandomState(1).randn(1, 4, HID).astype(np.float32)
    out_first = manager.decode("lim.0", "ttl-session", prompt, reset=True)
    assert manager._sessions[("lim.0", "ttl-session")].index == 4
    # a reset on the same id rebuilds the cache: index restarts, output identical
    out_reset = manager.decode("lim.0", "ttl-session", prompt, reset=True)
    np.testing.assert_array_equal(out_first, out_reset)
    assert manager._sessions[("lim.0", "ttl-session")].index == 4

    time.sleep(0.15)  # past the TTL
    manager.decode("lim.0", "fresh", prompt, reset=True)  # the sweep runs here
    assert ("lim.0", "ttl-session") not in manager._sessions
    with pytest.raises(KeyError, match="reset=True"):
        manager.decode("lim.0", "ttl-session", prompt[:, :1], reset=False)


def test_session_refuses_what_it_cannot_continue():
    manager = DecodeSessionManager(_decode_backend(), max_len=6)
    rng = np.random.RandomState(2)
    manager.decode("lim.0", "s", rng.randn(2, 5, HID).astype(np.float32), reset=True)
    with pytest.raises(ValueError, match="only 1-token steps"):
        manager.decode("lim.0", "s", rng.randn(2, 2, HID).astype(np.float32), reset=False)
    with pytest.raises(ValueError, match="batch is 2"):
        manager.decode("lim.0", "s", rng.randn(1, 1, HID).astype(np.float32), reset=False)
    manager.decode("lim.0", "s", rng.randn(2, 1, HID).astype(np.float32), reset=False)
    with pytest.raises(ValueError, match="full"):
        manager.decode("lim.0", "s", rng.randn(2, 1, HID).astype(np.float32), reset=False)
    with pytest.raises(ValueError, match="max_len"):
        manager.decode("lim.0", "t", rng.randn(1, 7, HID).astype(np.float32), reset=True)
    with pytest.raises(KeyError, match="does not support"):
        manager.decode("nope", "s", rng.randn(1, 1, HID).astype(np.float32), reset=True)


@pytest.mark.parametrize("block,kwargs", DECODER_CASES, ids=[case[0] for case in DECODER_CASES])
def test_continuous_batching_merges_concurrent_steps(block, kwargs):
    """Concurrent single-token steps of 5 sessions through ``decode_async`` run as
    merged device calls and match the same sessions decoded alone. The prompts
    differ in length, so every merged step writes, masks and rotates each row at
    its own position."""
    backend = _backends(block, kwargs, seed=7)[1]
    # a long recency window: the prefills of a loaded machine must not age out
    manager = DecodeSessionManager({"cb.0": backend}, max_len=32, merge_recency_s=60.0)
    merged = []
    batched_step = manager._batched_step

    def recorded(uid, x, cache_k, cache_v, index):
        merged.append(x.shape[0])
        assert len(set(index.tolist())) == x.shape[0]  # every row at its own position
        return batched_step(uid, x, cache_k, cache_v, index)

    manager._batched_step = recorded
    num_clients, steps = 5, 3
    prompts = [4 + 3 * client for client in range(num_clients)]
    rng = np.random.RandomState(7)
    inputs = [rng.randn(1, prompt + steps, HID).astype(np.float32) for prompt in prompts]
    expected = []
    for hidden, prompt in zip(inputs, prompts):
        session = uuid.uuid4().hex
        manager.decode("cb.0", session, hidden[:, :prompt], reset=True)
        expected.append([manager.decode("cb.0", session, hidden[:, t : t + 1], False) for t in range(prompt, prompt + steps)])
    assert merged == []  # steps decoded one at a time never merge

    sessions = [uuid.uuid4().hex for _ in range(num_clients)]
    for hidden, session, prompt in zip(inputs, sessions, prompts):
        manager.decode("cb.0", session, hidden[:, :prompt], reset=True)

    async def lockstep():
        outputs = []
        for step in range(steps):
            outputs.append(await asyncio.gather(*(
                manager.decode_async("cb.0", session, hidden[:, prompt + step : prompt + step + 1], False)
                for hidden, session, prompt in zip(inputs, sessions, prompts))))
        return outputs

    outputs = asyncio.run(lockstep())
    assert merged and max(merged) >= 2, merged
    for step, round_outputs in enumerate(outputs):
        for client, out in enumerate(round_outputs):
            assert out.shape == (1, 1, HID)
            np.testing.assert_allclose(out, expected[client][step], rtol=BATCHED_RTOL, atol=BATCHED_ATOL)
    assert all(manager._sessions[("cb.0", s)].index == prompt + steps for s, prompt in zip(sessions, prompts))
    assert manager._in_flight == {} and manager._pending == {}


def test_merged_step_leaves_each_session_its_own_cache():
    """A merged step stacks the sessions' caches for one call; afterwards each
    session still holds its own storage (not a view of the stack, which would keep
    every merged session's cache alive), with the new position written into it."""
    backend = _backends("llama_block", {"num_heads": 4, "num_kv_heads": 2}, seed=3)[1]
    manager = DecodeSessionManager({"own.0": backend}, max_len=16, merge_recency_s=60.0)
    stacks = []
    batched_step = manager._batched_step
    manager._batched_step = lambda *args: stacks.append(batched_step(*args)) or stacks[-1]
    rng = np.random.RandomState(3)
    sessions = [uuid.uuid4().hex for _ in range(3)]
    for length, session in zip((4, 5, 6), sessions):
        manager.decode("own.0", session, rng.randn(1, length, HID).astype(np.float32), reset=True)
    before = {s: manager._sessions[("own.0", s)].cache_k[0].untyped_storage().data_ptr() for s in sessions}
    steps = [rng.randn(1, 1, HID).astype(np.float32) for _ in sessions]

    async def one_round():
        return await asyncio.gather(*(manager.decode_async("own.0", s, x, False) for s, x in zip(sessions, steps)))

    asyncio.run(one_round())
    assert stacks, "no merged step ran"
    _, [stack_k], [stack_v] = stacks[-1]  # one shard: a single-device backend
    stack_storages = {stack_k.untyped_storage().data_ptr(), stack_v.untyped_storage().data_ptr()}
    for row, (length, session) in enumerate(zip((4, 5, 6), sessions)):
        state = manager._sessions[("own.0", session)]
        assert state.index == length + 1
        [cache_k], [cache_v] = state.cache_k, state.cache_v
        assert cache_k.untyped_storage().data_ptr() == before[session]
        assert {cache_k.untyped_storage().data_ptr(), cache_v.untyped_storage().data_ptr()}.isdisjoint(stack_storages)
        torch.testing.assert_close(cache_k[0], stack_k[row], rtol=0, atol=0)
        torch.testing.assert_close(cache_v[0], stack_v[row], rtol=0, atol=0)
    # the survivor of a group that left the merge steps alone, on its own cache
    survivor = manager._sessions[("own.0", sessions[0])]
    for session in sessions[1:]:
        del manager._sessions[("own.0", session)]
    del stacks[:], stack_k, stack_v
    manager.decode("own.0", sessions[0], rng.randn(1, 1, HID).astype(np.float32), reset=False)
    assert survivor.index == 6 and survivor.cache_k[0].untyped_storage().data_ptr() == before[sessions[0]]


def test_drain_cancellation_releases_pins_and_unblocks_callers():
    """Killing the drainer mid-batch must drop the eviction pins and cancel the
    stranded callers' futures."""
    manager = DecodeSessionManager(_decode_backend("pin.0"), max_len=32, merge_recency_s=60.0)
    rng = np.random.RandomState(0)
    sid = uuid.uuid4().hex
    manager.decode("pin.0", sid, rng.randn(1, 4, HID).astype(np.float32), reset=True)
    # a second recent session keeps the drainer path engaged
    manager.decode("pin.0", uuid.uuid4().hex, rng.randn(1, 4, HID).astype(np.float32), reset=True)
    release, entered = threading.Event(), threading.Event()

    def stuck_batch(uid, entries):
        entered.set()
        release.wait(10)
        raise RuntimeError("batch aborted")

    manager._decode_batch = stuck_batch

    async def scenario():
        step = asyncio.create_task(manager.decode_async("pin.0", sid, rng.randn(1, 1, HID).astype(np.float32), False))
        await asyncio.get_running_loop().run_in_executor(None, entered.wait, 10)
        drainer = manager._drainers["pin.0"]
        drainer.cancel()
        with pytest.raises(asyncio.CancelledError):
            await drainer
        release.set()
        with pytest.raises(asyncio.CancelledError):
            await step
        assert manager._in_flight == {}, "eviction pins leaked after drain cancellation"

    asyncio.run(scenario())
    with pytest.raises(KeyError, match="reset=True"):
        asyncio.run(manager.decode_async("pin.0", "unknown", np.zeros((1, 1, HID), np.float32), False))


# ------------------------------------------------------------------ generation

LLAMA_HID, HEADS, KV_HEADS, INNER, LAYERS, VOCAB = 64, 4, 2, 96, 2, 96


def _write_checkpoint(path, seed=0):
    """A tiny sharded HF-layout Llama checkpoint with an untied head."""
    rng = np.random.RandomState(seed)
    (path / "config.json").write_text(json.dumps({
        "hidden_size": LLAMA_HID, "num_attention_heads": HEADS, "num_key_value_heads": KV_HEADS,
        "intermediate_size": INNER, "num_hidden_layers": LAYERS, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    }))
    kv, scale = KV_HEADS * LLAMA_HID // HEADS, LLAMA_HID**-0.5
    weight_map = {}
    for layer in range(LAYERS):
        prefix = f"model.layers.{layer}."
        tensors = {
            prefix + "self_attn.q_proj.weight": rng.randn(LLAMA_HID, LLAMA_HID) * scale,
            prefix + "self_attn.k_proj.weight": rng.randn(kv, LLAMA_HID) * scale,
            prefix + "self_attn.v_proj.weight": rng.randn(kv, LLAMA_HID) * scale,
            prefix + "self_attn.o_proj.weight": rng.randn(LLAMA_HID, LLAMA_HID) * scale,
            prefix + "mlp.gate_proj.weight": rng.randn(INNER, LLAMA_HID) * scale,
            prefix + "mlp.up_proj.weight": rng.randn(INNER, LLAMA_HID) * scale,
            prefix + "mlp.down_proj.weight": rng.randn(LLAMA_HID, INNER) * INNER**-0.5,
            prefix + "input_layernorm.weight": 1.0 + 0.1 * rng.randn(LLAMA_HID),
            prefix + "post_attention_layernorm.weight": 1.0 + 0.1 * rng.randn(LLAMA_HID),
        }
        shard = f"model-{layer:05d}-of-{LAYERS:05d}.safetensors"
        save_file({k: v.astype(np.float32) for k, v in tensors.items()}, path / shard)
        weight_map.update({name: shard for name in tensors})
    head = {
        "model.embed_tokens.weight": rng.randn(VOCAB, LLAMA_HID) * scale,
        "model.norm.weight": 1.0 + 0.1 * rng.randn(LLAMA_HID),
        "lm_head.weight": rng.randn(VOCAB, LLAMA_HID) * scale,
    }
    save_file({k: v.astype(np.float32) for k, v in head.items()}, path / "model-head.safetensors")
    weight_map.update({name: "model-head.safetensors" for name in head})
    (path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))


class LocalPipe:
    """``decode_step`` chained over block uids through one session manager: the
    stand-in for the remote pipeline of the transport slice."""

    def __init__(self, manager, uids):
        self.manager, self.uids = manager, uids

    def decode_step(self, hidden, session_id, reset=False):
        x = torch.as_tensor(hidden).cpu().numpy()
        for uid in self.uids:
            x = self.manager.decode(uid, session_id, x, reset)
        return x


def test_greedy_generation_matches_a_teacher_forced_jax_replay(tmp_path):
    _write_checkpoint(tmp_path)
    backends, config = load_llama_blocks(tmp_path, device="cpu")
    head = LlamaClientHead.load(tmp_path, device="cpu")
    jax_head = JaxLlamaClientHead.load(tmp_path)
    assert head.vocab_size == VOCAB and not torch.equal(head.lm_head_matrix, head.embed_matrix)
    np.testing.assert_array_equal(head.embed([[3, 5]]).numpy(), jax_head.embed(np.array([[3, 5]])))
    hidden = np.random.RandomState(4).randn(2, 3, LLAMA_HID).astype(np.float32)
    np.testing.assert_allclose(head.logits(hidden).numpy(), jax_head.logits(hidden), rtol=1e-5, atol=1e-5)

    pipe = LocalPipe(DecodeSessionManager(backends, max_len=64), list(backends))
    prompt = np.random.RandomState(21).randint(0, VOCAB, size=(1, 6))
    generated = generate_greedy(head, pipe, prompt, max_new_tokens=8)
    assert generated.shape == (1, 14) and generated.dtype == np.int64
    np.testing.assert_array_equal(generated[:, :6], prompt)

    # teacher-forced replay of the generated sequence through the JAX blocks, no
    # cache: both compute in bf16, so a near-tied top-2 may flip, and the chosen
    # token's logit must lie within bf16 noise of the best
    jax_backends, _ = jax_load_llama_blocks(tmp_path)
    replay = jax_head.embed(generated)
    for uid in sorted(jax_backends):
        replay = jax_backends[uid].forward(replay)[0]
    logits = jax_head.logits(replay)
    for t in range(6, 14):
        best, chosen = float(np.max(logits[0, t - 1])), float(logits[0, t - 1, generated[0, t]])
        assert best - chosen <= 2e-2 * max(abs(best), 1.0), (t, best - chosen)


def test_decode_cache_bytes_matches_jax():
    for kv_heads, batch, max_len in ((32, 1, 1024), (8, 3, 77)):
        fields = dict(hidden_size=4096, num_attention_heads=32, num_key_value_heads=kv_heads,
                      intermediate_size=11008, num_hidden_layers=2)
        ours = decode_cache_bytes(LlamaCheckpointConfig(**fields), batch, max_len)
        assert ours == jax_decode_cache_bytes(JaxLlamaCheckpointConfig(**fields), batch, max_len)
        module = name_to_block["llama_block"](4096, num_heads=32, num_kv_heads=kv_heads, device="meta")
        assert ours == sum(t.numel() * t.element_size() for t in module.init_decode_cache(batch, max_len, "meta"))
