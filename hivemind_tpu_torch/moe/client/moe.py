"""RemoteMixtureOfExperts: route each input to its top-k experts across the swarm
and mix their outputs (the port of hivemind_tpu/moe/client/moe.py).

The gate is a trainable projection ``proj [in_features, sum(grid_size)]``; each
grid dimension's slice of ``x @ proj`` scores that dimension's coordinates, and an
expert's logit is the sum of its coordinates' scores. A beam search over the DHT
(``MoEBeamSearcher``) picks each sample's candidates, ONE batched
``RemoteCallMany`` calls them all concurrently (alive-mask fault tolerance), and the
mixture is a masked softmax over the ``[batch, k]`` slots, on the caller's device.
``proj`` is made as the JAX package makes it
(``np.random.RandomState(seed).randn(in_features, sum(grid_size)) * 0.01``), so
both packages start from the same gate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe.client.beam_search import MoEBeamSearcher
from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS, RemoteCallMany
from hivemind_tpu_torch.moe.client.expert import RemoteExpert
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
from hivemind_tpu_torch.p2p import P2P
from hivemind_tpu_torch.utils.device import resolve_device
from hivemind_tpu_torch.utils.loop import get_loop_runner


class RemoteMixtureOfExperts(nn.Module):
    """:param grid_size: the experts live on a grid of this shape under ``uid_prefix``
    :param k_best: experts per sample
    :param k_min: responses each sample needs on the forward, else the call raises
    :param backward_k_min: gradients each sample needs on the backward
    :param timeout_after_k_min: extra seconds granted to stragglers once every
        sample has its ``k_min`` responses
    :param device: where ``proj`` lives and the mixture is computed; ``"cuda"``
        unless the caller asks for the CPU

    After each call, ``last_experts`` holds each sample's chosen uids and
    ``last_alive`` the ``[batch, k]`` alive mask of its fan-out."""

    def __init__(
        self,
        *,
        dht: DHT,
        in_features: int,
        grid_size: Sequence[int],
        uid_prefix: str,
        k_best: int = 4,
        k_min: int = 1,
        backward_k_min: int = 1,
        forward_timeout: Optional[float] = None,
        backward_timeout: Optional[float] = None,
        timeout_after_k_min: Optional[float] = None,
        beam_size: Optional[int] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.dht = dht
        self.p2p: P2P = get_loop_runner().run_coroutine(dht.replicate_p2p())
        self.grid_size = tuple(grid_size)
        self.k_best, self.k_min, self.backward_k_min = k_best, k_min, backward_k_min
        self.forward_timeout, self.backward_timeout = forward_timeout, backward_timeout
        self.timeout_after_k_min = timeout_after_k_min
        self.beam_size = beam_size if beam_size is not None else k_best * 2
        self.beam_searcher = MoEBeamSearcher(dht, uid_prefix, grid_size)
        gate = np.random.RandomState(seed).randn(in_features, sum(self.grid_size)) * 0.01
        self.proj = nn.Parameter(torch.tensor(gate, dtype=torch.float32, device=device))
        self._experts: Dict[str, RemoteExpert] = {}
        self.last_experts: List[List[str]] = []
        self.last_alive: Optional[np.ndarray] = None

    def _get_expert(self, info: ExpertInfo) -> RemoteExpert:
        expert = self._experts.get(info.uid)
        if expert is None:
            expert = self._experts[info.uid] = RemoteExpert(info, self.p2p)
        elif expert.expert_info != info:
            expert.update_info(info)  # the replica set or the primary moved
        return expert

    def expert_scorecards(self) -> Dict[str, dict]:
        """This client's serving scorecards for the experts this mixture has called:
        success rate, latency quantiles, timeouts, sheds (the caller-side view that
        rides the DHT telemetry snapshot)."""
        from hivemind_tpu_torch.telemetry.serving import SCORECARDS

        cards = SCORECARDS.export()
        return {uid: cards[uid] for uid in self._experts if uid in cards}

    def _split_scores(self, flat_scores: torch.Tensor) -> List[torch.Tensor]:
        return list(torch.split(flat_scores, self.grid_size, dim=1))

    def _uid_coords(self, uid: str) -> List[int]:
        """Grid coordinates: the part of the uid after the grid prefix (the prefix may
        hold numeric parts itself, e.g. per-layer grids 'ffn.3.')."""
        prefix = self.beam_searcher.uid_prefix
        if not uid.startswith(prefix):
            raise ValueError(f"expert {uid!r} is not on the grid {prefix!r}")
        return [int(c) for c in uid[len(prefix):].split(".")]

    def _search(self, grid_scores: List[torch.Tensor]) -> List[List[ExpertInfo]]:
        host_scores = [scores.detach().to("cpu", torch.float32).numpy() for scores in grid_scores]
        return self.beam_searcher.batch_find_best_experts(host_scores, self.beam_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [batch, in_features]`` on ``proj``'s device; returns the mixture
        ``[batch, out_features]`` (expert choice is data-dependent, so eager)."""
        grid_scores = self._split_scores(x @ self.proj)
        return self._mix(x, grid_scores, self._search(grid_scores))

    def _mix(self, x: torch.Tensor, grid_scores: List[torch.Tensor], chosen: List[List[ExpertInfo]]) -> torch.Tensor:
        batch_size = x.shape[0]
        # breaker-aware routing: an expert whose circuit is hard-open is demoted below
        # every live candidate, so a dead expert does not take one of a sample's
        # k_best slots while healthy ones rank lower (``in`` is a pure read; the
        # half-open probes happen in the fan-out)
        sample_experts = []
        for candidates in chosen:
            live = [info for info in candidates if info.uid not in EXPERT_BREAKERS]
            banned = [info for info in candidates if info.uid in EXPERT_BREAKERS]
            sample_experts.append((live + banned)[: self.k_best])
        if not any(sample_experts):
            raise RuntimeError("beam search found no experts; is any server declared on this grid?")
        k = max(len(infos) for infos in sample_experts)

        rows = [[self._get_expert(info) for info in infos] + [None] * (k - len(infos)) for infos in sample_experts]
        call_many = RemoteCallMany(rows, k_min=self.k_min, backward_k_min=self.backward_k_min,
                                   forward_timeout=self.forward_timeout, backward_timeout=self.backward_timeout,
                                   timeout_after_k_min=self.timeout_after_k_min)
        outputs, alive = call_many(x)  # [batch, k, d_out], [batch, k]

        # logit[b, slot] = sum over dimensions of grid_scores[d][b, coord_d]
        coords = np.zeros((batch_size, k, len(self.grid_size)), np.int64)
        valid = np.zeros((batch_size, k), bool)
        for sample, infos in enumerate(sample_experts):
            for slot, info in enumerate(infos):
                coords[sample, slot] = self._uid_coords(info.uid)
                valid[sample, slot] = True
        coords = torch.from_numpy(coords).to(x.device)
        logits = sum(torch.gather(scores, 1, coords[:, :, dim]) for dim, scores in enumerate(grid_scores))
        mask = torch.from_numpy(valid).to(x.device) & alive
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))  # finite: -inf NaNs the softmax grad
        weights = torch.where(mask, torch.softmax(logits, dim=-1), torch.zeros_like(logits))  # dead slots: exactly 0
        self.last_experts = [[info.uid for info in infos] for infos in sample_experts]
        self.last_alive = alive.cpu().numpy()
        return torch.einsum("bk,bkd->bd", weights, outputs.to(weights.dtype))


class RemoteSwitchMixtureOfExperts(RemoteMixtureOfExperts):
    """Switch-Transformer routing: the top-1 expert, multiplicative jitter on the
    gate's input, grid dropout for load spreading, and a utilization EMA for
    load-balancing diagnostics. Its defaults ``k_min = backward_k_min = 0``: a
    sample whose expert fails contributes zeros instead of failing the batch.

    :param grid_dropout: keep-probability per grid coordinate per call; a dropped
        coordinate gets a -1e9 score, so no sample routes to it in this batch (a
        whole dimension is never dropped). 1.0 disables dropout.

    The jitter and dropout draw from ``np.random.RandomState(beam_size)``, as the
    JAX package's do."""

    def __init__(self, *, jitter_eps: float = 1e-2, utilization_alpha: float = 0.01, grid_dropout: float = 1.0,
                 **kwargs):
        kwargs.setdefault("k_best", 1)
        kwargs.setdefault("k_min", 0)
        kwargs.setdefault("backward_k_min", 0)
        super().__init__(**kwargs)
        self.jitter_eps = jitter_eps
        self.utilization_alpha = utilization_alpha
        self.grid_dropout = grid_dropout
        self.grid_utilization = [np.full(size, 1.0 / size, np.float64) for size in self.grid_size]
        self._jitter_rng = np.random.RandomState(self.beam_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the jitter perturbs the gate's input only: the experts see x itself, and
        # one beam search runs
        noise = self._jitter_rng.uniform(1 - self.jitter_eps, 1 + self.jitter_eps, size=(x.shape[0], 1))
        noise = torch.from_numpy(noise.astype(np.float32)).to(x.device)
        grid_scores = self._split_scores((x * noise) @ self.proj)
        if self.grid_dropout < 1.0:
            keep_masks = [self._jitter_rng.rand(size) < self.grid_dropout for size in self.grid_size]
            for dim, keep in enumerate(keep_masks):
                if not keep.any():
                    # never drop a whole dimension (routing would fall to tie-breaks
                    # among -1e9 scores): keep the coordinate the gate likes best
                    keep[int(torch.argmax(grid_scores[dim].detach().mean(dim=0)))] = True
            grid_scores = [torch.where(torch.from_numpy(keep).to(x.device)[None, :], scores,
                                       torch.full_like(scores, -1e9))
                           for scores, keep in zip(grid_scores, keep_masks)]
        chosen = self._search(grid_scores)
        self._update_utilization(chosen)
        return self._mix(x, grid_scores, chosen)

    def _update_utilization(self, chosen: List[List[ExpertInfo]]) -> None:
        alpha = self.utilization_alpha
        for sample_infos in chosen:
            for info in sample_infos[:1]:  # top-1 routing
                for dim, coord in enumerate(self._uid_coords(info.uid)):
                    self.grid_utilization[dim] *= 1 - alpha
                    self.grid_utilization[dim][coord] += alpha
