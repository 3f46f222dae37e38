"""Carry weights across from the JAX package: a flax parameter tree of one expert
block (as numpy arrays) becomes the port block's ``state_dict``.

- Dense ``kernel [in, out]`` → Linear ``weight [out, in]`` (transposed);
- ``bias`` keeps its name (LayerNorm biases too);
- a norm's ``scale`` → the norm's ``weight``;
- a top-level ``scale`` (the 'nop' expert's dummy parameter) stays ``scale``.

Module names are shared between the two packages (``query``, ``ffn_norm``,
``LayerNorm_0``, ...), so ``query/kernel`` becomes ``query.weight``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hivemind_tpu_torch.moe.server.layers import name_to_block


def from_flax_params(block_name: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` is the flax tree under ``"params"`` for a block registered as
    ``block_name``; returns fp32 CPU tensors keyed like the port block's state_dict."""
    if block_name not in name_to_block:
        raise KeyError(f"unknown expert block {block_name!r}; known: {sorted(name_to_block)}")
    state: Dict[str, torch.Tensor] = {}
    for module_name, leaves in params.items():
        if not isinstance(leaves, Mapping):  # a parameter of the block itself
            state[module_name] = torch.from_numpy(np.array(leaves, dtype=np.float32))
            continue
        for leaf_name, value in leaves.items():
            array = np.array(value, dtype=np.float32)
            if leaf_name == "kernel":
                state[f"{module_name}.weight"] = torch.from_numpy(np.ascontiguousarray(array.T))
            elif leaf_name == "scale":
                state[f"{module_name}.weight"] = torch.from_numpy(array)
            elif leaf_name == "bias":
                state[f"{module_name}.bias"] = torch.from_numpy(array)
            else:
                raise KeyError(f"{block_name}: no mapping for flax leaf {module_name}/{leaf_name}")
    return state
