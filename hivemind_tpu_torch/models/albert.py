"""ALBERT masked-LM, the flagship collaborative-pretraining model (the port of
hivemind_tpu/models/albert.py): factorized embeddings (vocab → embedding_size →
hidden_size), one transformer block shared by every layer, and a decoder tied to
the word embeddings.

Numerics follow the flax model: parameters are fp32, dense layers and norms
compute in ``config.dtype`` (bf16 by default), LayerNorm eps is 1e-6, gelu is the
tanh form, and logits are fp32. Parameter names follow the flax tree
(``shared_layer.query.weight`` is flax's ``shared_layer/query/kernel``,
transposed; see ``hivemind_tpu_torch/convert.py``). Attention goes through
``mesh_attention_core``, so on the card an unmasked encode runs the flash
kernels in both directions.

``make_train_step`` builds the model and its optimizer on a device (``cuda``
unless the caller asks for the CPU) and returns ``(model, train_step)``;
``train_step(batch)`` runs one forward, backward and optimizer step, updating
the model's parameters in place, and returns the loss.

On a mesh (``AlbertConfig(mesh=make_mesh(dp, tp, sp, ...))``) each rank builds its
part of the model and takes its ``[dp, sp]`` block of the batch (``shard_batch``):
- the leaves of the mesh's sharding rules are tensor-parallel over ``tp``: query, key,
  value and ffn_up keep their rank's columns (heads), attention_out and ffn_down their
  rows, whose partial outputs are summed over ``tp`` before the bias;
- the sequence is split over ``sp``: each rank embeds its positions and attention runs
  as ring attention (``mesh_attention_core``);
- the loss is the global batch's (every rank returns the same value), and a rank's
  ``backward`` leaves its share of each gradient: the shares summed over ``dp`` and
  ``sp`` are the gradient of the whole batch, which ``train_step`` computes before its
  update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hivemind_tpu_torch.moe.server.layers.common import Dense, LayerNorm, _gelu, init_parameters
from hivemind_tpu_torch.parallel.mesh import copy_to, reduce_from, shard_state_dict
from hivemind_tpu_torch.parallel.ring_attention import mesh_attention_core
from hivemind_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # recompute each shared-layer application in the backward
    mesh: Optional[Any] = None  # a parallel.mesh.Mesh: tensor parallelism over tp, ring attention over sp

    @property
    def head_dim(self) -> int:
        assert self.hidden_size % self.num_heads == 0
        return self.hidden_size // self.num_heads

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"] if self.mesh is not None else 1

    @classmethod
    def base(cls, **overrides) -> "AlbertConfig":
        """The widths of the public ``albert-base-v2`` config."""
        return cls(**overrides)

    @classmethod
    def tiny(cls, **overrides) -> "AlbertConfig":
        defaults = dict(
            vocab_size=1024, embedding_size=32, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, max_position=128,
        )
        defaults.update(overrides)
        return cls(**defaults)


class RowParallelDense(Dense):
    """A Dense whose ranks along ``tp`` each hold rows of the weight (``[out, in / tp]``):
    the partial products are summed over ``tp`` in fp32, then the bias is added."""

    def __init__(self, in_features: int, out_features: int, mesh, device=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, device=device, dtype=dtype)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = F.linear(x.to(self.dtype), self.weight.to(self.dtype)).to(torch.float32)
        return reduce_from(partial, self.mesh, "tp").to(self.dtype) + self.bias.to(self.dtype)


class AlbertLayer(nn.Module):
    """One shared transformer block (post-layernorm, gelu FFN); on a mesh with ``tp > 1``
    each rank holds ``num_heads / tp`` heads and ``intermediate_size / tp`` ffn units."""

    def __init__(self, config: AlbertConfig, device=None):
        super().__init__()
        self.config = config
        hid, dtype, tp = config.hidden_size, config.dtype, config.tp
        if config.num_heads % tp or config.intermediate_size % tp:
            raise ValueError(f"{config.num_heads} heads and {config.intermediate_size} ffn units do not split over tp={tp}")
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hid, hid // tp, device=device, dtype=dtype))
        self.ffn_up = Dense(hid, config.intermediate_size // tp, device=device, dtype=dtype)
        if tp > 1:
            self.attention_out = RowParallelDense(hid // tp, hid, config.mesh, device=device, dtype=dtype)
            self.ffn_down = RowParallelDense(config.intermediate_size // tp, hid, config.mesh, device=device, dtype=dtype)
        else:
            self.attention_out = Dense(hid, hid, device=device, dtype=dtype)
            self.ffn_down = Dense(config.intermediate_size, hid, device=device, dtype=dtype)
        self.attention_norm = LayerNorm(hid, device=device, dtype=dtype)
        self.ffn_norm = LayerNorm(hid, device=device, dtype=dtype)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        batch, seq, _ = hidden.shape
        heads = (batch, seq, cfg.num_heads // cfg.tp, cfg.head_dim)
        branch = copy_to(hidden, cfg.mesh, "tp") if cfg.tp > 1 else hidden
        q, k, v = (proj(branch).reshape(heads) for proj in (self.query, self.key, self.value))
        context = mesh_attention_core(cfg.mesh, q, k, v, mask=mask)
        attn_out = self.attention_out(context.reshape(batch, seq, -1))
        hidden = self.attention_norm(hidden + attn_out)
        branch = copy_to(hidden, cfg.mesh, "tp") if cfg.tp > 1 else hidden
        down = self.ffn_down(_gelu(self.ffn_up(branch)))
        return self.ffn_norm(hidden + down)


class AlbertForMaskedLM(nn.Module):
    def __init__(self, config: AlbertConfig, device=None):
        super().__init__()
        self.config = config
        emb, hid, dtype = config.embedding_size, config.hidden_size, config.dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, emb, device=device)
        self.position_embeddings = nn.Parameter(torch.empty(config.max_position, emb, device=device))
        self.embedding_norm = LayerNorm(emb, device=device, dtype=dtype)
        self.embedding_projection = Dense(emb, hid, device=device, dtype=dtype)
        self.shared_layer = AlbertLayer(config, device=device)
        self.mlm_transform = Dense(hid, emb, device=device, dtype=dtype)
        self.mlm_norm = LayerNorm(emb, device=device, dtype=dtype)
        self.mlm_bias = nn.Parameter(torch.empty(config.vocab_size, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers in distribution: dense kernels ~ N(0, 1/fan_in),
        word embeddings ~ N(0, 1/embedding_size), position embeddings ~ N(0, 0.02²),
        norm scales 1, biases 0. On a mesh, each rank takes its block of the whole
        model's draw, so every rank draws the same weights from the same generator."""
        if self.config.mesh is not None:
            full = AlbertForMaskedLM(dataclasses.replace(self.config, mesh=None), device=self.mlm_bias.device)
            full.reset_parameters(generator)
            self.load_state_dict(shard_state_dict(full.state_dict(), self.config.mesh))
            return
        init_parameters(self, generator)
        with torch.no_grad():
            self.position_embeddings.normal_(0.0, 0.02, generator=generator)

    def encode(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        seq = input_ids.shape[1]
        start = cfg.mesh.coordinate["sp"] * seq if cfg.mesh is not None else 0  # this rank's positions
        x = self.word_embeddings(input_ids).to(cfg.dtype) + self.position_embeddings[None, start:start + seq].to(cfg.dtype)
        x = self.embedding_projection(self.embedding_norm(x))
        for _ in range(cfg.num_layers):  # cross-layer parameter sharing
            if cfg.remat:
                x = checkpoint(self.shared_layer, x, attention_mask, use_reentrant=False)
            else:
                x = self.shared_layer(x, attention_mask)
        return x

    def _mlm_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        dtype = self.config.dtype
        transformed = self.mlm_norm(_gelu(self.mlm_transform(hidden)))
        logits = F.linear(transformed.to(dtype), self.word_embeddings.weight.to(dtype))  # tied decoder
        return logits.to(torch.float32) + self.mlm_bias

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MLM logits ``[batch, seq, vocab]`` in fp32."""
        return self._mlm_logits(self.encode(input_ids, attention_mask))

    def loss_masked_only(self, input_ids: torch.Tensor, labels: torch.Tensor, mlm_mask: torch.Tensor,
                         budget: int) -> torch.Tensor:
        """MLM loss at the masked positions only, up to ``budget`` per row: the MLM
        head runs on the gathered positions instead of all of them. Rows with more
        masked positions than the budget contribute their first ``budget`` ones (over
        the whole row: on a mesh, a rank counts the masked positions of the ranks
        before it along ``sp``)."""
        mesh = self.config.mesh
        hidden = self.encode(input_ids)
        take = min(budget, input_ids.shape[1])
        # masked first, in order: a stable sort of an integer key (0 for masked)
        order = torch.argsort(1 - mlm_mask.to(torch.int32), dim=1, stable=True)[:, :take]
        selected_mask = torch.gather(mlm_mask, 1, order)
        if mesh is not None and mesh.shape["sp"] > 1:
            counts = mesh.all_gather(mlm_mask.to(torch.int64).sum(dim=1), "sp")
            before = sum(counts[:mesh.coordinate["sp"]], torch.zeros_like(counts[0]))
            selected_mask = selected_mask & (before[:, None] + torch.arange(take, device=order.device) < budget)
        selected_hidden = torch.gather(hidden, 1, order[..., None].expand(-1, -1, hidden.shape[-1]))
        selected_labels = torch.gather(labels, 1, order)
        return mlm_loss(self._mlm_logits(selected_hidden), selected_labels, selected_mask, mesh)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, mlm_mask: torch.Tensor, mesh: Optional[Any] = None) -> torch.Tensor:
    """Masked cross-entropy: ``mlm_mask`` selects the positions that were masked out.
    On a mesh the terms and the count are summed over ``dp`` and ``sp``: the loss of the
    whole batch, whose gradient on each rank is that rank's share."""
    log_probs = torch.log_softmax(logits, dim=-1)
    label_ll = torch.gather(log_probs, -1, labels[..., None].long())[..., 0]
    mask = mlm_mask.to(torch.float32)
    total, count = -(label_ll * mask).sum(), mask.sum()
    if mesh is not None:
        total, count = reduce_from(total, mesh, ("dp", "sp")), mesh.all_reduce(count.detach().clone(), ("dp", "sp"))
    return total / count.clamp_min(1.0)


def make_mlm_loss_fn(model: AlbertForMaskedLM, masked_loss_fraction: Optional[float] = None) -> Callable[[Batch], torch.Tensor]:
    """``loss(batch) -> scalar`` over the model's parameters, for
    ``dict(input_ids, labels, mlm_mask)`` (on a mesh, the rank's block of the batch).

    :param masked_loss_fraction: run the MLM head only on this fraction of
        positions per row (the masked ones, see ``loss_masked_only``); None keeps
        the exact full-logits objective."""

    mesh = model.config.mesh

    def loss_fn(batch: Batch) -> torch.Tensor:
        if masked_loss_fraction is not None:
            seq = batch["input_ids"].shape[1] * (mesh.shape["sp"] if mesh is not None else 1)
            budget = max(1, int(seq * masked_loss_fraction))
            return model.loss_masked_only(batch["input_ids"], batch["labels"], batch["mlm_mask"], budget)
        return mlm_loss(model(batch["input_ids"]), batch["labels"], batch["mlm_mask"], mesh)

    return loss_fn


def make_train_step(
    config: AlbertConfig,
    optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
    masked_loss_fraction: Optional[float] = None,
    device: Union[str, torch.device] = "cuda",
    rng_seed: int = 0,
) -> Tuple[AlbertForMaskedLM, Callable[[Batch], torch.Tensor]]:
    """``(model, train_step)``: the model built on ``device`` with parameters drawn
    from ``rng_seed``, and a step that runs forward, backward and one update of
    ``optimizer(model.parameters())`` (e.g. ``lambda p: torch.optim.AdamW(p,
    lr=1e-4, weight_decay=1e-4)``, the JAX package's ``optax.adamw(1e-4)``).
    ``train_step(batch)`` returns the loss as a 0-d tensor on the device.

    With ``config.mesh``, ``device`` is the type of the mesh's device (the rank's card),
    ``batch`` is the rank's block (``parallel.shard_batch``), the gradients are summed
    over ``dp`` and ``sp`` before the update, and the optimizer updates the rank's
    shards, so it must act element by element (``torch.optim``'s SGD, Adam, AdamW)."""
    device = resolve_device(device)
    mesh = config.mesh
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh computes on {mesh.device}, the train step was asked for {device}")
        device = mesh.device
    model = AlbertForMaskedLM(config, device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(rng_seed))
    opt = optimizer(model.parameters())
    loss_fn = make_mlm_loss_fn(model, masked_loss_fraction)

    def train_step(batch: Batch) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        if mesh is not None:
            reduce_gradients(model, mesh)
        opt.step()
        return loss.detach()

    return model, train_step


def reduce_gradients(model: nn.Module, mesh: Any) -> None:
    """Sum each parameter's gradient share over ``dp`` and ``sp``, in one flat buffer."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    mesh.all_reduce(flat, ("dp", "sp"))
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()


def make_synthetic_mlm_batch(generator: torch.Generator, config: AlbertConfig, batch_size: int, seq_len: int) -> Batch:
    """Synthetic MLM data on the generator's device: uniform labels, 15% of
    positions masked (Bernoulli), masked inputs set to ``vocab_size - 1``."""
    device = generator.device
    labels = torch.randint(0, config.vocab_size, (batch_size, seq_len), generator=generator, device=device)
    mlm_mask = torch.rand((batch_size, seq_len), generator=generator, device=device) < 0.15
    input_ids = torch.where(mlm_mask, torch.full_like(labels, config.vocab_size - 1), labels)
    return {"input_ids": input_ids, "labels": labels, "mlm_mask": mlm_mask}
