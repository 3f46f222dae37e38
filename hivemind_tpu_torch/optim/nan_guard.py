"""NaN/Inf training guard with periodic host backups of the trainer state (the port
of hivemind_tpu/optim/nan_guard.py; upstream: examples/albert/run_trainer.py:62-130,
where the flagship recipe keeps a host-side copy of the full trainer state and rolls
back to it instead of poisoning the swarm when a peer's loss turns non-finite)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from hivemind_tpu_torch.optim.grad_scaler import all_finite
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class NaNGuard:
    """Backs up ``optimizer.state_dict()`` (host numpy copies) every ``backup_every``
    healthy steps; a step with a non-finite loss restores the backup (parameters,
    optimizer statistics AND epoch; schedules replay to it) and drops the poisoned
    gradients.

    :param optimizer: a :class:`hivemind_tpu_torch.optim.Optimizer`
    :param backup_every: healthy steps between state snapshots
    :param check_grads: also scan the gradients (the ``grads`` given, or each
        parameter's ``.grad``) for non-finite values
    """

    def __init__(self, optimizer, backup_every: int = 30, check_grads: bool = False):
        self.optimizer = optimizer
        self.backup_every = max(int(backup_every), 1)
        self.check_grads = check_grads
        self._backup: Optional[dict] = None
        self._healthy_steps = 0
        self.restores = 0
        self.skipped_steps = 0

    def step(self, loss, grads: Any = None, batch_size: Optional[int] = None) -> Any:
        """Drop-in for ``optimizer.step(grads)`` with the loss routed through.
        Returns the (possibly restored) parameters."""
        loss_value = float(loss.detach()) if isinstance(loss, torch.Tensor) else float(np.asarray(loss))
        finite = bool(np.isfinite(loss_value))
        if finite and self.check_grads:
            finite = all_finite(grads if grads is not None else
                                [p.grad for p in self.optimizer.params.values() if p.grad is not None])
        if not finite:
            self.skipped_steps += 1
            if self._backup is not None:
                self.optimizer.load_state_dict(self._backup)
                self.restores += 1
                logger.error(
                    f"non-finite loss ({loss_value:.3g}); restored the backup from epoch "
                    f"{self._backup.get('epoch')} (restore #{self.restores}) and dropped this step's gradients"
                )
            else:
                logger.error("non-finite loss before any backup existed; dropping the step (no state to restore yet)")
            return self.optimizer.params

        if self._backup is None or self._healthy_steps % self.backup_every == 0:
            self._backup = self.optimizer.state_dict()
        self._healthy_steps += 1
        kwargs = {} if batch_size is None else {"batch_size": batch_size}
        return self.optimizer.step(grads, **kwargs)
