"""Swarm resilience layer (the port's copy of hivemind_tpu/resilience/): unified
retry/backoff/deadline policies, cross-layer circuit breakers, and a
deterministic chaos/fault-injection engine. Metric names, board names, injection
points and the ``HIVEMIND_CHAOS`` grammar are the JAX package's; the port's
transport, DHT and client are its callers."""

from hivemind_tpu_torch.resilience.breaker import (
    BreakerBoard,
    BreakerOpenError,
    BreakerState,
    CircuitBreaker,
    all_board_states,
    reset_all_boards,
)
from hivemind_tpu_torch.resilience.chaos import (
    ACTIONS,
    CHAOS,
    ChaosAbort,
    ChaosDrop,
    ChaosEngine,
    ChaosError,
    INJECTION_POINTS,
)
from hivemind_tpu_torch.resilience.policy import Deadline, DeadlineExceeded, RetryPolicy

__all__ = [
    "ACTIONS",
    "BreakerBoard",
    "BreakerOpenError",
    "BreakerState",
    "CHAOS",
    "ChaosAbort",
    "ChaosDrop",
    "ChaosEngine",
    "ChaosError",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "INJECTION_POINTS",
    "RetryPolicy",
    "all_board_states",
    "reset_all_boards",
]
