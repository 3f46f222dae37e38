"""Numeric helpers for low-rank gradient compression (the port of
hivemind_tpu/utils/math_utils.py, in numpy; upstream: hivemind/utils/math.py — orthogonalize_, get_flatten_greedy_dims)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def orthogonalize(matrix: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Column-wise Gram-Schmidt (in place); the PowerSGD P-phase orthogonalization."""
    for col in range(matrix.shape[1]):
        column = matrix[:, col]
        norm = np.linalg.norm(column)
        column /= max(norm, eps)
        if col + 1 < matrix.shape[1]:
            rest = matrix[:, col + 1 :]
            rest -= np.outer(column, column @ rest)
    return matrix


def get_flatten_greedy_dims(shape: Tuple[int, ...], max_ndim: int = 2) -> Tuple[int, int]:
    """Flatten an nd shape into 2D [m, n] keeping m as close to n as possible —
    maximizes the energy a rank-r factorization can capture."""
    numel = int(np.prod(shape))
    if numel == 0:
        return (0, 1)
    best = (numel, 1)
    m = 1
    for dim in shape:
        m *= dim
        n = numel // m
        if abs(m - n) < abs(best[0] - best[1]):
            best = (m, n)
    return best
