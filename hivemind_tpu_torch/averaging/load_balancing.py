"""Bandwidth-aware partitioning of the butterfly all-reduce
(the port of hivemind_tpu/averaging/load_balancing.py; upstream: hivemind/averaging/load_balancing.py).

Peer i reduces a fraction f_i of the concatenated vector. Its wire traffic is
(n-1)·f_i·S inbound parts + (n-1)·f_i·S outbound deltas + (1-f_i)·S sent + (1-f_i)·S
received, so time_i ∝ ((n-2)·f_i + 1)/bandwidth_i. We minimize the max over peers
(minimax LP, upstream optimize_parts_lp at load_balancing.py:36-86), then round the
fractions to integer part counts by largest remainder (Hagenbach-Bischoff,
upstream 89-105). Zero-bandwidth peers (client mode) get zero parts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
# at module load, never on the event loop: a cold import in the middle of a round
# stalled it past its timeouts. scipy's HiGHS is the JAX package's solver, and only
# the same call on the same float64 arrays gives every peer the same part counts
from scipy.optimize import linprog

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def optimize_parts_lp(vector_size: int, bandwidths: np.ndarray, min_size: int = 0) -> np.ndarray:
    """Solve the minimax LP for load fractions. Returns fractions summing to 1."""
    group_size = len(bandwidths)
    active = bandwidths > 0
    if not np.any(active):
        raise ValueError("all peers have zero bandwidth: nobody can reduce")
    if active.sum() == 1:
        return active.astype(np.float64)

    # variables: [f_0 … f_{n-1}, t]; minimize t
    # constraints: ((n-2)·f_i + 1) / b_i ≤ t  for active i;  Σf = 1;  f_i ≥ 0; f_inactive = 0
    n = group_size
    c = np.zeros(n + 1)
    c[-1] = 1.0
    a_ub = np.zeros((int(active.sum()), n + 1))
    b_ub = np.zeros(int(active.sum()))
    row = 0
    for i in range(n):
        if not active[i]:
            continue
        a_ub[row, i] = max(n - 2, 1) / bandwidths[i]
        a_ub[row, -1] = -1.0
        b_ub[row] = -1.0 / bandwidths[i]
        row += 1
    a_eq = np.zeros((1, n + 1))
    a_eq[0, :n] = 1.0
    b_eq = [1.0]
    bounds = [(0.0, None) if active[i] else (0.0, 0.0) for i in range(n)] + [(0.0, None)]
    result = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq, bounds=bounds, method="highs")
    if not result.success:
        logger.warning(f"load-balancing LP failed ({result.message}); falling back to proportional split")
        fractions = np.where(active, bandwidths, 0.0)
        return fractions / fractions.sum()
    fractions = np.clip(result.x[:-1], 0.0, None)
    total = fractions.sum()
    return fractions / total if total > 0 else np.where(active, 1.0 / active.sum(), 0.0)


def hagenbach_bischoff(num_parts: int, fractions: np.ndarray) -> np.ndarray:
    """Largest-remainder apportionment of num_parts into integer counts ∝ fractions."""
    ideal = fractions * num_parts
    counts = np.floor(ideal).astype(np.int64)
    remainder = num_parts - counts.sum()
    if remainder > 0:
        order = np.argsort(-(ideal - counts))
        counts[order[:remainder]] += 1
    return counts


def load_balance_peers(
    vector_size: int, bandwidths: Sequence[Optional[float]], min_size: int = 0
) -> Tuple[int, ...]:
    """Main entry (upstream load_balancing.py:13-33): ``bandwidths`` entries are
    floats (reducer capacity) or None/0 for client-mode peers. Returns per-peer part
    counts out of ``vector_size`` elements."""
    bandwidth_array = np.array([b if b is not None else 0.0 for b in bandwidths], dtype=np.float64)
    if np.any(bandwidth_array > 0):
        fractions = optimize_parts_lp(vector_size, bandwidth_array, min_size)
    else:
        raise ValueError("group has no peers capable of reducing (all client-mode?)")
    counts = hagenbach_bischoff(vector_size, fractions)
    # peers whose share fell below min_size contribute nothing; redistribute
    if min_size > 0:
        starved = (counts > 0) & (counts < min_size)
        if np.any(starved):
            freed = counts[starved].sum()
            counts[starved] = 0
            if counts.sum() > 0:
                top = np.argmax(counts)
                counts[top] += freed
    assert counts.sum() == vector_size
    return tuple(int(c) for c in counts)
