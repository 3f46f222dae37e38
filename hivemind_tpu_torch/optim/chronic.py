"""Chronic-averaging-failure tracking of the ``Optimizer`` (the port of
hivemind_tpu/optim/chronic.py, with the same metric names; behavior introduced for the
host optimizer:
consecutive epochs that degrade to local gradients escalate to ERROR and back
matchmaking off exponentially — a persistently failing peer must not silently
train local SGD forever, nor hammer the DHT at full cadence).

Host classes mix this in and provide ``chronic_failure_threshold``,
``matchmaking_time``, ``averaging_timeout``, and ``_consecutive_failed_rounds``
attributes; ``_chronic_peer_noun`` names the subject in log lines."""

from __future__ import annotations

from typing import Optional

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# layer-4 telemetry: swarm-round outcomes and the chronic counter
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY

_ROUND_OUTCOMES = _TELEMETRY.counter(
    "hivemind_optim_averaging_rounds_total", "attempted swarm averaging rounds", ("outcome",)
)
_G_CONSECUTIVE_FAILURES = _TELEMETRY.gauge(
    "hivemind_optim_consecutive_failed_rounds",
    "epochs in a row that degraded to local gradients (chronic past the threshold)",
).labels()


class ChronicFailureTracking:
    _chronic_peer_noun = "peer"

    @property
    def consecutive_failed_averaging_rounds(self) -> int:
        """Epochs in a row that fell back to local gradients (0 = healthy)."""
        return self._consecutive_failed_rounds

    @property
    def chronic_averaging_failure(self) -> bool:
        """True once ``chronic_failure_threshold`` consecutive epochs degraded to
        local SGD — the swarm is effectively unreachable for this peer."""
        return self._consecutive_failed_rounds >= self.chronic_failure_threshold

    def _should_log_chronic(self) -> bool:
        # a multi-card peer logs only from its network process; host peers always log
        return bool(getattr(self, "is_network_process", True))

    def _record_round_outcome(self, averaged_ok: Optional[bool]) -> None:
        """``averaged_ok``: True/False for an attempted swarm round, None when no
        round was attempted (num_peers <= 1 — a solo peer is healthy, not failing)."""
        if averaged_ok is None:
            return
        _ROUND_OUTCOMES.inc(outcome="ok" if averaged_ok else "degraded_to_local")
        if averaged_ok:
            if self.chronic_averaging_failure and self._should_log_chronic():
                logger.info(
                    f"swarm averaging recovered after "
                    f"{self._consecutive_failed_rounds} failed epochs"
                )
            self._consecutive_failed_rounds = 0
            _G_CONSECUTIVE_FAILURES.set(0)
            return
        self._consecutive_failed_rounds += 1
        _G_CONSECUTIVE_FAILURES.set(self._consecutive_failed_rounds)
        if self._consecutive_failed_rounds == self.chronic_failure_threshold and self._should_log_chronic():
            logger.error(
                f"{self._consecutive_failed_rounds} consecutive epochs degraded to local "
                f"gradients — this {self._chronic_peer_noun} is training local SGD, not "
                f"collaborating; check connectivity/matchmaking (backing off matchmaking "
                f"exponentially)"
            )

    def _matchmaking_delay(self) -> float:
        """Matchmaking lead time, exponentially backed off under chronic failure
        (cap 8×), and never past half the averaging timeout — a scheduled_time
        beyond the step deadline would make every later round fail by
        construction, locking the peer in chronic failure even after the network
        heals."""
        excess = self._consecutive_failed_rounds - self.chronic_failure_threshold
        if excess < 0:
            delay = self.matchmaking_time
        else:
            delay = self.matchmaking_time * min(2.0 ** (excess + 1), 8.0)
        ceiling = getattr(self, "averaging_timeout", None)
        if ceiling:
            delay = min(delay, max(ceiling / 2.0, self.matchmaking_time))
        return delay
