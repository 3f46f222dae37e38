"""Decoder-only causal LM (the port of hivemind_tpu/models/causal_lm.py): the GPT-family
counterpart of the ALBERT masked-LM flagship. Pre-norm blocks of causal attention and a
gelu FFN, learned position embeddings, and logits tied to the word embeddings.

Numerics follow the flax model: parameters are fp32, dense layers and norms compute in
``config.dtype`` (bf16 by default), LayerNorm eps is 1e-6 with fp32 statistics, gelu is
the tanh form, and logits are fp32. The residual stream stays in ``config.dtype``, as
in the flax model, where every sum on it is a bf16 sum. Parameter names follow the flax
tree (``layer_0.query.weight`` is flax's ``layer_0/query/kernel``, transposed; see
``hivemind_tpu_torch/convert.py``), so ``parallel/mesh.py``'s sharding rules match them.
Attention goes through ``mesh_attention_core(causal=True)``: on the card the causal flash
kernels in both directions, on a mesh with ``sp > 1`` causal ring attention.

On a mesh (``CausalLMConfig(mesh=make_mesh(dp, tp, sp, ...))``) each rank builds its part
of the model and takes its ``[dp, sp]`` block of the batch (``shard_batch``), as ALBERT on
a mesh does (``models/albert.py``): query, key, value and ffn_up keep the rank's columns,
attention_out and ffn_down its rows; embeddings and norms are replicated. Each rank embeds
its own positions. The target of a rank's last position is the next ``sp`` rank's first
token, and the last ``sp`` rank drops its last position, so the loss is the whole batch's
mean over ``B·(T − 1)`` terms on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hivemind_tpu_torch.models.albert import RowParallelDense, reduce_gradients
from hivemind_tpu_torch.moe.server.layers.common import Dense, LayerNorm, _gelu, init_parameters
from hivemind_tpu_torch.parallel.mesh import copy_to, reduce_from, shard_state_dict
from hivemind_tpu_torch.parallel.ring_attention import mesh_attention_core
from hivemind_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # recompute each layer in the backward
    mesh: Optional[Any] = None  # a parallel.mesh.Mesh: tensor parallelism over tp, causal ring attention over sp

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"] if self.mesh is not None else 1

    @classmethod
    def base(cls, **overrides) -> "CausalLMConfig":
        """GPT-2-small widths with a Llama-sized vocabulary (the JAX package's default)."""
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "CausalLMConfig":
        defaults = dict(
            vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


class DecoderLayer(nn.Module):
    """One pre-norm decoder block: causal attention and a gelu FFN, each added to the
    residual stream; on a mesh with ``tp > 1`` the rank holds ``num_heads / tp`` heads
    and ``intermediate_size / tp`` ffn units."""

    def __init__(self, config: CausalLMConfig, device=None):
        super().__init__()
        self.config = config
        hid, dtype, tp = config.hidden_size, config.dtype, config.tp
        if config.num_heads % tp or config.intermediate_size % tp:
            raise ValueError(f"{config.num_heads} heads and {config.intermediate_size} ffn units do not split over tp={tp}")
        self.attention_norm = LayerNorm(hid, device=device, dtype=dtype)
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hid, hid // tp, device=device, dtype=dtype))
        self.ffn_norm = LayerNorm(hid, device=device, dtype=dtype)
        self.ffn_up = Dense(hid, config.intermediate_size // tp, device=device, dtype=dtype)
        if tp > 1:
            self.attention_out = RowParallelDense(hid // tp, hid, config.mesh, device=device, dtype=dtype)
            self.ffn_down = RowParallelDense(config.intermediate_size // tp, hid, config.mesh, device=device, dtype=dtype)
        else:
            self.attention_out = Dense(hid, hid, device=device, dtype=dtype)
            self.ffn_down = Dense(config.intermediate_size, hid, device=device, dtype=dtype)

    def _branch(self, normed: torch.Tensor) -> torch.Tensor:
        # the norm is replicated: its output enters the rank's columns, so its gradient
        # is summed over tp (Megatron's f) before it reaches the norm
        cfg = self.config
        return copy_to(normed, cfg.mesh, "tp") if cfg.tp > 1 else normed

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        batch, seq, _ = hidden.shape
        heads = (batch, seq, cfg.num_heads // cfg.tp, cfg.head_dim)
        normed = self._branch(self.attention_norm(hidden))
        q, k, v = (proj(normed).reshape(heads) for proj in (self.query, self.key, self.value))
        context = mesh_attention_core(cfg.mesh, q, k, v, causal=True)
        hidden = hidden + self.attention_out(context.reshape(batch, seq, -1))
        normed = self._branch(self.ffn_norm(hidden))
        return hidden + self.ffn_down(_gelu(self.ffn_up(normed)))


class CausalLM(nn.Module):
    def __init__(self, config: CausalLMConfig, device=None):
        super().__init__()
        self.config = config
        hid = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, hid, device=device)
        self.position_embeddings = nn.Parameter(torch.empty(config.max_position, hid, device=device))
        for i in range(config.num_layers):  # named as flax names them: layer_0, layer_1, ...
            self.add_module(f"layer_{i}", DecoderLayer(config, device=device))
        self.final_norm = LayerNorm(hid, device=device, dtype=config.dtype)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.config.num_layers)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers in distribution: dense kernels ~ N(0, 1/fan_in), word
        embeddings ~ N(0, 1/hidden_size), position embeddings ~ N(0, 0.02²), norm scales
        1, biases 0. On a mesh, each rank takes its block of the whole model's draw."""
        if self.config.mesh is not None:
            full = CausalLM(dataclasses.replace(self.config, mesh=None), device=self.position_embeddings.device)
            full.reset_parameters(generator)
            self.load_state_dict(shard_state_dict(full.state_dict(), self.config.mesh))
            return
        init_parameters(self, generator)
        with torch.no_grad():
            self.position_embeddings.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Next-token logits ``[batch, seq, vocab]`` in fp32 (the decoder is the word
        embeddings, transposed: flax's ``Embed.attend``)."""
        cfg = self.config
        seq = input_ids.shape[1]
        start = cfg.mesh.coordinate["sp"] * seq if cfg.mesh is not None else 0  # this rank's positions
        x = self.word_embeddings(input_ids).to(cfg.dtype) + self.position_embeddings[None, start:start + seq].to(cfg.dtype)
        for layer in self.layers:
            x = checkpoint(layer, x, use_reentrant=False) if cfg.remat else layer(x)
        x = self.final_norm(x)
        return F.linear(x.to(cfg.dtype), self.word_embeddings.weight.to(cfg.dtype)).to(torch.float32)


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor, mesh: Optional[Any] = None) -> torch.Tensor:
    """Next-token cross-entropy: position t predicts token t+1, and the sequence's last
    position has no target and is dropped. On a mesh, ``logits`` and ``input_ids`` are the
    rank's ``[dp, sp]`` block: the target of its last position is the next ``sp`` rank's
    first token (the last ``sp`` rank drops its last position), and the terms and their
    count are summed over ``dp`` and ``sp``, so every rank returns the whole batch's mean
    and its gradient on each rank is that rank's share."""
    targets = input_ids[:, 1:]
    if mesh is not None and mesh.shape["sp"] > 1:
        # every rank sends its first tokens one step back along the ring (a collective);
        # the last rank's share from rank 0 is not a target
        (following,) = mesh.ring_shift([input_ids[:, :1].contiguous()], "sp", -1)
        if mesh.coordinate["sp"] < mesh.shape["sp"] - 1:
            targets = torch.cat([targets, following], dim=1)
    log_probs = torch.log_softmax(logits[:, :targets.shape[1]], dim=-1)
    token_ll = torch.gather(log_probs, -1, targets[..., None].long())[..., 0]
    if mesh is None:
        return -token_ll.mean()
    total = reduce_from(-token_ll.sum(), mesh, ("dp", "sp"))
    count = mesh.all_reduce(torch.tensor(float(token_ll.numel()), device=logits.device), ("dp", "sp"))
    return total / count


def make_lm_loss_fn(model: CausalLM) -> Callable[[Batch], torch.Tensor]:
    """``loss(batch) -> scalar`` over the model's parameters, for ``dict(input_ids)`` (on a
    mesh, the rank's block of the batch)."""
    return lambda batch: causal_lm_loss(model(batch["input_ids"]), batch["input_ids"], model.config.mesh)


def make_train_step(
    config: CausalLMConfig,
    optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
    device: Union[str, torch.device] = "cuda",
    rng_seed: int = 0,
) -> Tuple[CausalLM, Callable[[Batch], torch.Tensor]]:
    """``(model, train_step)``: the model built on ``device`` with parameters drawn from
    ``rng_seed``, and a step that runs forward, backward and one update of
    ``optimizer(model.parameters())``; ``train_step(dict(input_ids))`` returns the loss as a
    0-d tensor on the device. On a mesh, as ALBERT's ``make_train_step``: ``device`` is
    the type of the mesh's device, the batch is the rank's block, the gradients are
    summed over ``dp`` and ``sp`` before the update, and the optimizer acts element by
    element."""
    device = resolve_device(device)
    mesh = config.mesh
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh computes on {mesh.device}, the train step was asked for {device}")
        device = mesh.device
    model = CausalLM(config, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(rng_seed))
    opt = optimizer(model.parameters())
    loss_fn = make_lm_loss_fn(model)

    def train_step(batch: Batch) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh)
        opt.step()
        return loss.detach()

    return model, train_step


def make_synthetic_lm_batch(generator: torch.Generator, config: CausalLMConfig, batch_size: int, seq_len: int) -> Batch:
    """A synthetic token stream, uniform over the vocabulary, on the generator's device."""
    input_ids = torch.randint(0, config.vocab_size, (batch_size, seq_len), generator=generator, device=generator.device)
    return {"input_ids": input_ids}
