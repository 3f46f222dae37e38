"""GradScaler analog (the port of hivemind_tpu/optim/grad_scaler.py; upstream:
hivemind/optim/grad_scaler.py:25-127).

Upstream's scaler exists because fp16 training needs dynamic loss scaling synchronized
with global (epoch) steps. The port trains in bf16, whose exponent range matches fp32,
so, like the JAX package's, this class is an API-compatible pass-through that only
tracks non-finite gradients; fp16 loss scaling would be a feature the JAX package
lacks. Unscale/update stay deferred to global optimizer steps."""

from __future__ import annotations

import threading

import numpy as np
import torch

from hivemind_tpu_torch.optim.transforms import tree_leaves
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def all_finite(grads) -> bool:
    """True if every leaf of ``grads`` (torch tensors or numpy arrays) is finite."""
    for leaf in tree_leaves(grads):
        if isinstance(leaf, torch.Tensor):
            if not bool(torch.isfinite(leaf).all()):
                return False
        elif not bool(np.isfinite(np.asarray(leaf)).all()):
            return False
    return True


class GradScaler:
    def __init__(self, init_scale: float = 1.0, enabled: bool = True):
        if init_scale != 1.0:
            logger.warning(
                "bf16 training needs no loss scaling; GradScaler runs with scale=1 "
                "(fp16-style dynamic scaling is a no-op here by design)"
            )
        self._enabled = enabled
        self._found_inf = False
        self._lock = threading.RLock()

    def scale(self, value):
        return value  # the scale is always 1 in bf16

    def unscale_(self, grads) -> bool:
        """Record non-finite gradients (returns True if grads are clean)."""
        with self._lock:
            self._found_inf = not all_finite(grads)
            return not self._found_inf

    def step(self, apply_fn, *args, **kwargs):
        """Run the optimizer update unless the last unscale_ found inf/nan."""
        with self._lock:
            if self._found_inf:
                logger.warning("skipping optimizer step: non-finite gradients")
                return None
            return apply_fn(*args, **kwargs)

    def update(self) -> None:
        with self._lock:
            self._found_inf = False

    def get_scale(self) -> float:
        return 1.0  # bf16: scaling is always identity

    @property
    def found_inf(self) -> bool:
        return self._found_inf
