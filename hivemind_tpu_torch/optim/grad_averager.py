"""Gradient accumulation + swarm averaging (the port of
hivemind_tpu/optim/grad_averager.py; upstream: hivemind/optim/grad_averager.py).

Gradients arrive as torch tensors on the card or the host, or as numpy arrays; the
accumulators are float32 HOST buffers (the all-reduce reads the host anyway), filled
with a multiply and then an add, as the JAX package fills its own, and divided by the
sample count only when they are loaded into the averaged tensors. Three buffer roles
as upstream (grad_averager.py:23-29): live gradients (the caller's), local
accumulators, and the averager's shared averaged-gradient tensors."""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.averaging.control import StepControl
from hivemind_tpu_torch.averaging.partition import host_array
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration

logger = get_logger(__name__)


class GradientAverager(DecentralizedAverager):
    """Accumulates local gradients toward a virtual large batch, then averages the
    accumulated gradients with a group of peers.

    :param tensors_like: arrays or tensors defining the gradient shapes (the averaged
        tensors' schema: the Optimizer passes the parameters in the JAX package's
        layout, so both packages' peers meet in one group)
    """

    def __init__(
        self,
        tensors_like: Sequence,
        *,
        dht: DHT,
        prefix: str,
        reuse_grad_buffers: bool = False,
        accumulate_grads_on_host: bool = True,
        **kwargs,
    ):
        self.reuse_grad_buffers = reuse_grad_buffers
        shapes = [tuple(t.shape) for t in tensors_like]
        # accumulate_grads_on_host=False skips the host accumulator allocation (a full
        # model copy) for callers that stage gradients straight into the shared tensors
        self._grad_accumulators: Optional[List[np.ndarray]] = (
            [np.zeros(shape, np.float32) for shape in shapes] if accumulate_grads_on_host else None
        )
        self.local_samples_accumulated = 0
        self.local_times_accumulated = 0
        self._new_averaged_grads = False
        super().__init__(
            averaged_tensors=[np.zeros(shape, np.float32) for shape in shapes], dht=dht, prefix=prefix, **kwargs
        )

    def accumulate_grads_(self, grads: Iterable, batch_size: int) -> None:
        """Add one microbatch's gradients (torch tensors on any device or numpy arrays,
        already averaged over the microbatch) scaled by its size (upstream
        grad_averager.py:129-148): a multiply, then an add."""
        grads = list(grads)
        assert self._grad_accumulators is not None, (
            "this averager was built with accumulate_grads_on_host=False — "
            "gradients are staged externally into the shared tensors"
        )
        assert len(grads) == len(self._grad_accumulators), (
            f"got {len(grads)} gradient tensors, expected {len(self._grad_accumulators)}"
        )
        for accumulator, grad in zip(self._grad_accumulators, grads):
            accumulator += np.asarray(host_array(grad), dtype=np.float32) * batch_size
        self.local_samples_accumulated += batch_size
        self.local_times_accumulated += 1

    def schedule_step(self, scheduled_time: Optional[DHTExpiration] = None, **kwargs) -> StepControl:
        """Begin matchmaking early; the accumulated gradients are loaded and the
        all-reduce triggered later, by step(control=...) (upstream
        grad_averager.py:163-184). Bypasses this class's step override: accumulators
        must NOT be loaded yet."""
        assert kwargs.get("weight") is None, "weight is set automatically at trigger time"
        return DecentralizedAverager.step(
            self, scheduled_time=scheduled_time, wait=False, require_trigger=True, **kwargs
        )

    def step(
        self,
        weight: Optional[float] = None,
        control: Optional[StepControl] = None,
        reset_accumulators: bool = True,
        load_accumulators: bool = True,
        wait: bool = True,
        timeout: Optional[float] = None,
        **kwargs,
    ):
        """Average the accumulated gradients with the group; fills the shared
        averaged-gradient buffers (upstream grad_averager.py:163-201).

        :param load_accumulators: stage the live accumulators into the shared buffers
            now. Delayed (DPU) updates stage them at schedule time instead and pass
            False, so gradients of the NEXT epoch accumulating concurrently cannot
            leak into the in-flight round."""
        if control is None:
            control = super().step(weight=weight, wait=False, require_trigger=True, timeout=timeout, **kwargs)
        elif weight is not None:
            control.weight = weight
        if load_accumulators:
            self.load_accumulators_into_averager_()
            if control.weight == 1.0 and self.local_samples_accumulated > 0:
                control.weight = self.local_samples_accumulated
            if reset_accumulators:
                self.reset_accumulated_grads_()
        control.allow_allreduce()
        return control.result(timeout) if wait else control

    def load_accumulators_into_averager_(self) -> None:
        """Normalize accumulators by sample count and copy into the shared tensors
        (upstream grad_averager.py:203-210)."""
        assert self._grad_accumulators is not None, (
            "accumulate_grads_on_host=False: stage into the shared tensors directly"
        )
        denominator = max(self.local_samples_accumulated, 1)
        with self.get_tensors() as tensors:
            for tensor, accumulator in zip(tensors, self._grad_accumulators):
                np.divide(accumulator, denominator, out=tensor.numpy())
        self._new_averaged_grads = True

    def reset_accumulated_grads_(self) -> None:
        if self._grad_accumulators is not None:
            for accumulator in self._grad_accumulators:
                accumulator.fill(0.0)
        self.local_samples_accumulated = 0
        self.local_times_accumulated = 0

    @contextlib.contextmanager
    def use_averaged_gradients(self) -> Iterator[List[torch.Tensor]]:
        """The averaged gradients after a successful step, as CPU tensors that share the
        averager's buffers (upstream grad_averager.py:221-235 swaps ``param.grad``;
        the Optimizer copies them to the card and hands them to its update)."""
        self._new_averaged_grads = False
        with self.get_tensors() as tensors:
            yield tensors
