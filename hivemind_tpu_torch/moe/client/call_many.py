"""Batched, fault-tolerant scatter/gather to many experts (the port of
hivemind_tpu/moe/client/call_many.py, with the same semantics).

One autograd node covers the whole expert fan-out: the forward issues every
expert's forward RPC concurrently on the port's loop (a slow expert costs max(),
not sum()) and returns the stacked per-slot outputs and an alive mask; the backward
issues backward RPCs to the experts that answered. Per sample:

- ``k_min`` / ``backward_k_min``: at least this many live expert responses on the
  forward / backward, else the call raises;
- ``timeout_after_k_min``: once every sample has its needed responses, stragglers
  get at most this many more seconds, then they are abandoned (their slots stay
  masked) and counted as breaker failures;
- ``forward_timeout`` / ``backward_timeout``: hard deadlines of each pass.

The node works on float32 **host copies** and returns its outputs on the caller's
device: a node on CUDA tensors would run its backward on torch's CUDA engine
thread, which deadlocks a server in the same process while it waits for the
backward RPCs (``RemoteExpert.__call__`` does the same).
"""

from __future__ import annotations

import asyncio
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hivemind_tpu_torch.resilience.breaker import BreakerBoard, BreakerOpenError
from hivemind_tpu_torch.resilience.chaos import CHAOS as _CHAOS
from hivemind_tpu_torch.telemetry.serving import is_overload_error
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.loop import get_loop_runner
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

if TYPE_CHECKING:
    from hivemind_tpu_torch.moe.client.expert import RemoteExpert

logger = get_logger(__name__)

# cross-call expert health, shared by every client of this process (uid keys, and
# RemoteExpert's uid@peer replica keys): two consecutive failures trip an expert's
# breaker open for 30 s (doubling per re-trip); while open it is skipped at once,
# and the half-open probe re-admits it after recovery
EXPERT_BREAKERS = BreakerBoard(
    "moe_expert",
    failure_threshold=2,
    recovery_time=30.0,
    backoff_rate=2.0,
    max_recovery_time=600.0,
)


class RemoteCallMany:
    """Callable: ``outputs [batch, k, d_out], alive [batch, k] = rcm(x)``.

    :param experts_per_sample: for each sample, up to k experts (shorter rows are
        padded with None; a padded slot always reports dead)
    """

    def __init__(
        self,
        experts_per_sample: Sequence[Sequence[Optional["RemoteExpert"]]],
        *,
        k_min: int = 1,
        backward_k_min: int = 1,
        forward_timeout: Optional[float] = None,
        backward_timeout: Optional[float] = None,
        timeout_after_k_min: Optional[float] = None,
    ):
        self.experts_per_sample = [list(row) for row in experts_per_sample]
        self.batch_size = len(self.experts_per_sample)
        self.k_max = max((len(row) for row in self.experts_per_sample), default=0)
        if self.k_max == 0:
            raise ValueError("every sample needs at least one expert")
        self.k_min, self.backward_k_min = k_min, backward_k_min
        self.forward_timeout, self.backward_timeout = forward_timeout, backward_timeout
        self.timeout_after_k_min = timeout_after_k_min

        # expert uid -> (expert, [(sample, slot), ...]): ONE batched RPC per expert
        self.jobs: Dict[str, Tuple["RemoteExpert", List[Tuple[int, int]]]] = {}
        for sample, row in enumerate(self.experts_per_sample):
            for slot, expert in enumerate(row):
                if expert is not None:
                    self.jobs.setdefault(expert.uid, (expert, []))[1].append((sample, slot))

    def _real_slots(self, row) -> int:
        return sum(expert is not None for expert in row)

    # ------------------------------------------------------------------ fan-out core

    async def _fan_out(self, make_call, need_per_sample: int, timeout: Optional[float], job_uids: Sequence[str],
                       chaos_point: str = "moe.forward") -> Dict[str, List[np.ndarray]]:
        """One RPC per expert, concurrently; returns ``{uid: tensors}`` of those that
        answered in time, under the k_min / timeout_after_k_min policy. The
        per-expert breakers skip known-dead experts at once and record each
        outcome."""

        async def _guarded_call(uid: str):
            # one span per expert RPC, named after its chaos point, so an injected
            # fault is attributable to the exact call it hit
            expert = self.jobs[uid][0]
            with _tracing_span(chaos_point, expert=uid, peer=str(expert.p2p.peer_id), remote=str(expert.peer_id)):
                if not EXPERT_BREAKERS.allow(uid):
                    raise BreakerOpenError(f"expert {uid} breaker is open; skipping")
                if _CHAOS.enabled:  # injection point: per expert forward/backward RPC
                    await _CHAOS.inject(chaos_point, scope=uid)
                result = await make_call(expert, uid)
                EXPERT_BREAKERS.register_success(uid)
                return result

        loop_tasks = {asyncio.ensure_future(_guarded_call(uid)): uid for uid in job_uids}
        results: Dict[str, List[np.ndarray]] = {}
        alive_count = [0] * self.batch_size
        # the straggler deadline opens once every row has its needed responses (at
        # least ONE even under k_min=0, where a short row outputs zeros instead of
        # raising: the window must not open on the first answer and abandon the
        # rest); a row delivers at most its real experts, and an empty row is done
        needed = [min(max(need_per_sample, 1), self._real_slots(row)) for row in self.experts_per_sample]
        hard_deadline = get_dht_time() + timeout if timeout is not None else None
        soft_deadline = None

        pending = set(loop_tasks)
        try:
            while pending:
                now = get_dht_time()
                wait_for = None
                if hard_deadline is not None:
                    wait_for = max(hard_deadline - now, 0.0)
                if soft_deadline is not None:
                    soft_left = max(soft_deadline - now, 0.0)
                    wait_for = soft_left if wait_for is None else min(wait_for, soft_left)
                if wait_for is not None and wait_for <= 0:
                    break
                done, pending = await asyncio.wait(pending, timeout=wait_for, return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break  # a deadline
                for task in done:
                    uid = loop_tasks[task]
                    try:
                        results[uid] = task.result()
                        for sample, _slot in self.jobs[uid][1]:
                            alive_count[sample] += 1
                    except BreakerOpenError as e:
                        logger.debug(str(e))  # not fresh evidence: the breaker holds the failure
                    except Exception as e:
                        # a server's shed was already fed to the breaker by
                        # RemoteExpert._call: one shed counts as one failure
                        if not is_overload_error(e):
                            EXPERT_BREAKERS.register_failure(uid)
                        logger.warning(f"expert {uid} failed: {e!r}; masking it out")
                if (soft_deadline is None and self.timeout_after_k_min is not None
                        and all(count >= need for count, need in zip(alive_count, needed))):
                    soft_deadline = get_dht_time() + self.timeout_after_k_min
        finally:
            for task in pending:
                task.cancel()
                # an abandoned straggler never reached the success/failure paths:
                # record the failure here, or the breaker never trips on a hang
                EXPERT_BREAKERS.register_failure(loop_tasks[task])
        return results

    # ------------------------------------------------------------------ forward

    def _forward_np(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        d_out = self._output_dim()
        x = np.asarray(x, np.float32)

        async def call_forward(expert: "RemoteExpert", uid: str):
            samples = [sample for sample, _ in self.jobs[uid][1]]
            return await expert._call("forward", [x[samples]])

        results = get_loop_runner().run_coroutine(
            self._fan_out(call_forward, self.k_min, self.forward_timeout, list(self.jobs), chaos_point="moe.forward"))

        outputs = np.zeros((self.batch_size, self.k_max, d_out), np.float32)
        alive = np.zeros((self.batch_size, self.k_max), bool)
        for uid, tensors in results.items():
            out = np.asarray(tensors[0], np.float32)
            for position, (sample, slot) in enumerate(self.jobs[uid][1]):
                outputs[sample, slot] = out[position]
                alive[sample, slot] = True
        real_slots = [self._real_slots(row) for row in self.experts_per_sample]
        short = np.flatnonzero(alive.sum(1) < np.minimum(self.k_min, real_slots))
        if short.size:
            raise RuntimeError(f"samples {short.tolist()} got fewer than k_min={self.k_min} expert responses")
        return outputs, alive

    def _output_dim(self) -> int:
        last_error: Optional[Exception] = None
        for expert, _ in self.jobs.values():
            try:
                schema = expert.info["outputs_schema"][0]
                return int(np.prod(schema.shape[1:]))
            except Exception as e:  # an unreachable expert: its schema cannot be fetched
                last_error = e
        raise RuntimeError(f"could not fetch any expert's output schema: {last_error!r}")

    # ------------------------------------------------------------------ backward

    def _backward_np(self, x: np.ndarray, grad_outputs: np.ndarray, alive: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        grad_outputs = np.asarray(grad_outputs, np.float32)
        # only the experts that answered the forward take part in the backward
        live_uids = [uid for uid, (_expert, positions) in self.jobs.items()
                     if any(alive[sample, slot] for sample, slot in positions)]

        async def call_backward(expert: "RemoteExpert", uid: str):
            positions = self.jobs[uid][1]
            samples = [sample for sample, _ in positions]
            grads = np.stack([grad_outputs[sample, slot] for sample, slot in positions])
            return await expert._call("backward", [x[samples], grads])

        results = get_loop_runner().run_coroutine(
            self._fan_out(call_backward, self.backward_k_min, self.backward_timeout, live_uids,
                          chaos_point="moe.backward"))

        grad_x = np.zeros_like(x)
        grads_per_sample = [0] * self.batch_size
        for uid, tensors in results.items():
            grad = np.asarray(tensors[0], np.float32)
            for position, (sample, _slot) in enumerate(self.jobs[uid][1]):
                grad_x[sample] += grad[position]
                grads_per_sample[sample] += 1
        short = [sample for sample, row in enumerate(self.experts_per_sample)
                 if grads_per_sample[sample] < min(self.backward_k_min, self._real_slots(row))]
        if short:
            raise RuntimeError(f"samples {short} got fewer than backward_k_min={self.backward_k_min} gradients")
        return grad_x

    # ------------------------------------------------------------------ torch surface

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [batch, d_in]`` on any device; returns the outputs ``[batch, k, d_out]``
        (differentiable with respect to ``x``) and the alive mask ``[batch, k]``,
        both on ``x``'s device."""
        outputs, alive = _CallMany.apply(self, x.to("cpu", torch.float32))
        return outputs.to(x.device), alive.to(x.device)


class _CallMany(torch.autograd.Function):
    """The fan-out as an autograd node on float32 CPU tensors: forward RPCs in,
    backward RPCs (which step every live server's optimizer) out."""

    @staticmethod
    def forward(ctx, call_many: RemoteCallMany, x: torch.Tensor):
        outputs, alive = call_many._forward_np(x.detach().numpy())
        alive = torch.from_numpy(alive)
        ctx.call_many = call_many
        ctx.save_for_backward(x, alive)
        ctx.mark_non_differentiable(alive)
        return torch.from_numpy(outputs), alive

    @staticmethod
    def backward(ctx, grad_outputs: torch.Tensor, _grad_alive):
        x, alive = ctx.saved_tensors
        grad_x = ctx.call_many._backward_np(x.detach().numpy(), grad_outputs.detach().to(torch.float32).numpy(),
                                            alive.numpy())
        return None, torch.from_numpy(grad_x)
