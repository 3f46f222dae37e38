"""Deterministic dropout expert (the port of hivemind_tpu/moe/server/layers/dropout.py).

The dropout MASK travels as a second input tensor, so forward and backward apply
the same mask on the server even though they are separate RPCs: dropout drawn
from a server-side generator could not guarantee that across the wire. It is the
built-in two-input expert (``ModuleBackend(sample_inputs=...)``); autograd of
``x * mask / keep`` gives the backward."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from hivemind_tpu_torch.moe.server.layers.common import Dense, register_expert_class


class DeterministicDropout(nn.Module):
    """Dropout whose mask is an explicit input."""

    def __init__(self, drop_prob: float):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return x * mask / (1.0 - self.drop_prob)


def dropout_sample_input(batch_size: int, hid_dim: int):
    mask = (np.random.default_rng(0).random((batch_size, hid_dim)) > 0.2).astype(np.float32)
    return np.zeros((batch_size, hid_dim), np.float32), mask


@register_expert_class("det_dropout", dropout_sample_input)
class DeterministicDropoutExpert(nn.Module):
    """deterministic dropout -> linear -> relu -> linear, with the flax module's
    parameter names (``Dense_0``, ``Dense_1``; the dropout has none)."""

    def __init__(self, hidden_dim: int, dropout_prob: float = 0.2, device=None):
        super().__init__()
        self.dropout = DeterministicDropout(dropout_prob)
        self.Dense_0 = Dense(hidden_dim, 2 * hidden_dim, device=device)
        self.Dense_1 = Dense(2 * hidden_dim, hidden_dim, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.Dense_0(self.dropout(x, mask)))
        return self.Dense_1(h).to(torch.float32)
