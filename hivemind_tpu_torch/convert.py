"""Carry weights across from the JAX package and back: a flax parameter tree (as
numpy arrays) becomes the port model's ``state_dict``, and a block's
``state_dict`` becomes a flax tree again.

- Dense ``kernel [in, out]`` ↔ Linear ``weight [out, in]`` (transposed);
- ``bias`` keeps its name (LayerNorm biases too);
- a norm's ``scale`` ↔ the norm's ``weight``;
- an ``nn.Embed``'s ``embedding`` ↔ the ``nn.Embedding``'s ``weight``;
- a parameter of the model itself (the 'nop' expert's ``scale``, ALBERT's
  ``position_embeddings`` and ``mlm_bias``) keeps its name.

Module names are shared between the two packages (``query``, ``ffn_norm``,
``LayerNorm_0``, ``shared_layer``, ...), so ``shared_layer/query/kernel`` becomes
``shared_layer.query.weight``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hivemind_tpu_torch.moe.server.layers import name_to_block


def from_flax_albert_params(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax tree (under ``"params"``; the ``AlbertForMaskedLM`` tree or a block's)
    as fp32 CPU tensors keyed like the port model's ``state_dict()``."""
    state: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            state.update(from_flax_albert_params(value, f"{prefix}{name}."))
            continue
        array = np.array(value, dtype=np.float32)
        if not prefix:  # a parameter of the model itself
            state[name] = torch.from_numpy(array)
        elif name == "kernel":
            state[f"{prefix}weight"] = torch.from_numpy(np.ascontiguousarray(array.T))
        elif name in ("scale", "embedding"):
            state[f"{prefix}weight"] = torch.from_numpy(array)
        elif name == "bias":
            state[f"{prefix}bias"] = torch.from_numpy(array)
        else:
            raise KeyError(f"no mapping for flax leaf {prefix.replace('.', '/')}{name}")
    return state


def from_flax_params(block_name: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` is the flax tree under ``"params"`` for a block registered as
    ``block_name``; returns fp32 CPU tensors keyed like the port block's state_dict."""
    if block_name not in name_to_block:
        raise KeyError(f"unknown expert block {block_name!r}; known: {sorted(name_to_block)}")
    return from_flax_albert_params(params)


def to_flax_params(block_name: str, state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The inverse of :func:`from_flax_params` for a block: ``state`` (the block's
    parameters) as a flax tree of fp32 numpy arrays."""
    if block_name not in name_to_block:
        raise KeyError(f"unknown expert block {block_name!r}; known: {sorted(name_to_block)}")
    tree: Dict[str, object] = {}
    for key, tensor in state.items():
        array = torch.as_tensor(tensor).detach().to("cpu", torch.float32).numpy()
        if "." not in key:
            tree[key] = array
            continue
        module, leaf = key.rsplit(".", 1)
        if leaf == "weight":
            leaf, array = ("kernel", np.ascontiguousarray(array.T)) if array.ndim == 2 else ("scale", array)
        elif leaf != "bias":
            raise KeyError(f"{block_name}: no flax leaf for parameter {key}")
        tree.setdefault(module, {})[leaf] = array
    return tree
