"""Carry weights across from the JAX package and back: a flax parameter tree (as
numpy arrays) becomes the port model's ``state_dict``, and a block's
``state_dict`` becomes a flax tree again.

- Dense ``kernel [in, out]`` ↔ Linear ``weight [out, in]`` (transposed);
- ``bias`` keeps its name (LayerNorm biases too);
- a norm's ``scale`` ↔ the norm's ``weight``;
- an ``nn.Embed``'s ``embedding`` ↔ the ``nn.Embedding``'s ``weight``;
- a parameter of the model itself (the 'nop' expert's ``scale``, ALBERT's
  ``position_embeddings`` and ``mlm_bias``, the causal LM's ``position_embeddings``)
  keeps its name.

Module names are shared between the two packages (``query``, ``ffn_norm``,
``LayerNorm_0``, ``shared_layer``, the causal LM's ``layer_0``, ...), so
``shared_layer/query/kernel`` becomes ``shared_layer.query.weight``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


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
    from hivemind_tpu_torch.moe.server.layers import name_to_block

    if block_name not in name_to_block:
        raise KeyError(f"unknown expert block {block_name!r}; known: {sorted(name_to_block)}")
    return from_flax_albert_params(params)


def to_flax_params(block_name: str, state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The inverse of :func:`from_flax_params` for a block: ``state`` (the block's
    parameters) as a flax tree of fp32 numpy arrays."""
    from hivemind_tpu_torch.moe.server.layers import name_to_block

    if block_name not in name_to_block:
        raise KeyError(f"unknown expert block {block_name!r}; known: {sorted(name_to_block)}")
    return to_flax_tree(state)


# the port's ``nn.Embedding`` modules: flax's ``nn.Embed`` names the table
# ``embedding`` and keeps the ``[vocab, features]`` layout (no transpose)
EMBEDDING_MODULES = frozenset({"word_embeddings"})
# module names that say "embedding table" (Llama's ``embed_tokens``; not ALBERT's Dense
# ``embedding_projection``)
EMBEDDING_SUFFIXES = ("embed", "embeds", "embedding", "embeddings", "embed_tokens")


def flax_path(key: str, ndim: int) -> Tuple[Tuple[str, ...], bool]:
    """The flax path of the parameter ``key`` (a ``state_dict`` name) of ``ndim``
    dimensions, and whether its flax layout is the transpose of the torch one. A 2-D
    weight of a module whose name ends like an embedding's (``EMBEDDING_SUFFIXES``) but
    is not in ``EMBEDDING_MODULES`` raises: taking it for a Dense kernel would transpose
    it silently."""
    *modules, leaf = key.split(".")
    if not modules:  # a parameter of the model itself
        return (leaf,), False
    if leaf == "weight":
        if modules[-1] in EMBEDDING_MODULES:
            return (*modules, "embedding"), False
        if ndim == 2:
            if modules[-1].lower().endswith(EMBEDDING_SUFFIXES):
                raise KeyError(f"{key}: an embedding table not in convert.EMBEDDING_MODULES; add its module name")
            return (*modules, "kernel"), True
        return (*modules, "scale"), False
    if leaf != "bias":
        raise KeyError(f"no flax leaf for parameter {key}")
    return (*modules, leaf), False


def to_flax_tree(state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Parameters keyed like a module's ``state_dict`` as a flax tree of fp32 numpy
    arrays (copies), its keys sorted at every level as JAX's tree utilities order them (so
    the tree serializes to the JAX package's bytes)."""
    tree: Dict[str, object] = {}
    for key in sorted(state):
        # a copy: the tree must not alias parameters that a step later updates in place
        array = torch.as_tensor(state[key]).detach().to("cpu", torch.float32, copy=True).numpy()
        (*modules, leaf), transposed = flax_path(key, array.ndim)
        node = tree
        for module in modules:
            node = node.setdefault(module, {})
        node[leaf] = np.ascontiguousarray(array.T) if transposed else array
    return _sorted_tree(tree)


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {key: _sorted_tree(tree[key]) for key in sorted(tree)}
    return tree
