"""PowerSGD gradient averaging: rank-r factorization with error feedback (the port of
hivemind_tpu/optim/power_sgd_averager.py; upstream:
hivemind/optim/power_sgd_averager.py:28-222).

Each round runs TWO chained all-reduces inside one matchmade group: phase P averages
the projected matrices M·Q, which are then orthogonalized; phase Q averages Mᵀ·P
together with the uncompressed (1-d / tiny) tensors. Error feedback accumulates what
the rank-r approximation dropped, so compression error corrects itself over steps.
Matmuls/orthogonalization are small dense ops — numpy on host (they are tiny next to
the network transfer they eliminate), in the JAX package's operations and order."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np

from hivemind_tpu_torch.averaging.group_info import GroupInfo
from hivemind_tpu_torch.optim.grad_averager import GradientAverager
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.math_utils import get_flatten_greedy_dims, orthogonalize

logger = get_logger(__name__)


class PowerSGDGradientAverager(GradientAverager):
    """:param averager_rank: rank r of the factorization
    :param min_compression_ratio: tensors that rank-r would not compress by at least
        this factor are averaged uncompressed in phase Q (upstream behavior for 1-d
        and small tensors, power_sgd_averager.py:172-174)"""

    def __init__(
        self,
        tensors_like: Sequence,
        *,
        averager_rank: int = 1,
        min_compression_ratio: float = 0.5,
        **kwargs,
    ):
        self.rank = averager_rank
        self.min_compression_ratio = min_compression_ratio
        super().__init__(tensors_like, **kwargs)

        self._compressed_idx: List[int] = []
        self._uncompressed_idx: List[int] = []
        with self._host_tensors() as tensors:
            for i, tensor in enumerate(tensors):
                m, n = get_flatten_greedy_dims(tensor.shape)
                if self.rank * (m + n) < tensor.size * min_compression_ratio:
                    self._compressed_idx.append(i)
                else:
                    self._uncompressed_idx.append(i)
            # error feedback buffers (upstream _ms) + warm-start Qs: seeded identically
            # on every peer so the initial projections agree
            self._error_feedback = {i: np.zeros_like(tensors[i]) for i in self._compressed_idx}
            rng = np.random.RandomState(0xC0FFEE)
            self._qs = {}
            for i in self._compressed_idx:
                _m, n = get_flatten_greedy_dims(tensors[i].shape)
                self._qs[i] = np.asarray(rng.randn(n, self.rank), np.float32)

    async def _aggregate_with_group(self, group_info: GroupInfo, weight: float):
        bandwidths, modes, user_gathered, _adverts = self._decode_gathered(group_info)
        with self._host_tensors() as tensors:
            local = [t.copy() for t in tensors]

        ms = {}
        ps = []
        for i in self._compressed_idx:
            m_dims = get_flatten_greedy_dims(local[i].shape)
            ms[i] = (local[i] + self._error_feedback[i]).reshape(m_dims).astype(np.float32)
            ps.append(ms[i] @ self._qs[i])

        # phase P: average the projections (upstream 117-130)
        averaged_ps = await self._run_manual_allreduce(
            group_info, ps, group_id_suffix=b".phase_p",
            modes=modes, bandwidths=bandwidths, weight=weight,
        )
        for p in averaged_ps:
            orthogonalize(p)

        # phase Q: average Mᵀ·P and the uncompressed tensors together (upstream 161-178)
        qs = [ms[i].T @ p for i, p in zip(self._compressed_idx, averaged_ps)]
        raw = [local[i].astype(np.float32) for i in self._uncompressed_idx]
        averaged_phase_q = await self._run_manual_allreduce(
            group_info, qs + raw, group_id_suffix=b".phase_q",
            modes=modes, bandwidths=bandwidths, weight=weight,
        )
        averaged_qs = averaged_phase_q[: len(qs)]
        averaged_raw = averaged_phase_q[len(qs) :]

        # reconstruct, update error feedback, publish into the shared buffers
        with self._host_tensors() as tensors:
            for i, p, q in zip(self._compressed_idx, averaged_ps, averaged_qs):
                approx = (p @ q.T).reshape(tensors[i].shape)
                self._error_feedback[i] = ms[i].reshape(tensors[i].shape) - approx
                np.copyto(tensors[i], approx)
                self._qs[i] = q  # warm start for the next round
            for i, averaged in zip(self._uncompressed_idx, averaged_raw):
                np.copyto(tensors[i], averaged.reshape(tensors[i].shape))
        return user_gathered

    @contextlib.contextmanager
    def _host_tensors(self):
        """The averaged tensors as the numpy arrays they are views of."""
        with self.get_tensors() as tensors:
            yield [t.numpy() for t in tensors]

    def compression_ratio(self) -> float:
        with self._host_tensors() as tensors:
            full = sum(t.size for t in tensors)
            sent = sum(
                self.rank * sum(get_flatten_greedy_dims(tensors[i].shape)) for i in self._compressed_idx
            ) + sum(tensors[i].size for i in self._uncompressed_idx)
        return sent / max(full, 1)
