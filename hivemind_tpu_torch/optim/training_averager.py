"""TrainingAverager: the legacy simple averager — average parameters and/or gradients
after each local step, no epoch accounting (the port of
hivemind_tpu/optim/training_averager.py; upstream: hivemind/optim/training_averager.py:18-252)."""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.averaging.partition import host_array
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class TrainingAverager(DecentralizedAverager):
    """:param get_tensors_fn: callable returning the CURRENT list of tensors to average
        (torch on any device, or numpy); the averages are handed to ``set_tensors_fn``
        as float32 numpy arrays"""

    def __init__(
        self,
        *,
        dht: DHT,
        get_tensors_fn,
        set_tensors_fn,
        prefix: str,
        average_parameters: bool = True,
        average_gradients: bool = False,
        **kwargs,
    ):
        self.get_tensors_fn, self.set_tensors_fn = get_tensors_fn, set_tensors_fn
        self.average_parameters, self.average_gradients = average_parameters, average_gradients
        self.local_step = 0
        self._step_lock = threading.Lock()
        initial = [np.asarray(host_array(t), np.float32) for t in get_tensors_fn()]
        super().__init__(averaged_tensors=initial, dht=dht, prefix=prefix, **kwargs)

    def average_step(self, weight: float = 1.0, timeout: Optional[float] = None, **kwargs):
        """Load current tensors, run one averaging round, write the averages back
        (upstream TrainingAverager.step)."""
        with self._step_lock:
            current = [np.asarray(host_array(t), np.float32) for t in self.get_tensors_fn()]
            with self.get_tensors() as tensors:
                for buffer, fresh in zip(tensors, current):
                    buffer.numpy()[...] = fresh
            try:
                gathered = self.step(weight=weight, timeout=timeout, **kwargs)
            except Exception as e:
                logger.warning(f"averaging step failed: {e!r}")
                return None
            with self.get_tensors() as tensors:
                self.set_tensors_fn([t.numpy().copy() for t in tensors])
            self.local_step += 1
            return gathered
