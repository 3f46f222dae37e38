"""The port's chaos soak (``hivemind_cli/run_chaos_soak.py``) on the CPU: the same
configurations and checks as the JAX package's soak tests (``tests/test_resilience.py``),
with the trainers' parameters and the experts on ``device="cpu"``. The two smokes are
tier-1 (seeded, ~30 s and ~70 s here); the full 4-peer soaks are marked ``slow`` as the
JAX package's are."""

from __future__ import annotations

import pytest

from hivemind_tpu_torch.hivemind_cli.run_chaos_soak import run_soak
from hivemind_tpu_torch.resilience import CHAOS, reset_all_boards


@pytest.fixture(autouse=True)
def _reset_resilience_state():
    yield
    CHAOS.clear()
    reset_all_boards()


@pytest.mark.chaos
def test_chaos_soak_smoke():
    """2 trainers and an MoE server/client pair under the full default schedule:
    steps advance through and after the faults, breakers recover, faults land and the
    server's experts answer again once the faults stop."""
    report = run_soak(n_peers=2, duration=18.0, seed=0, chaos_fraction=0.55, include_moe=True, device="cpu")
    assert report["runs_on"] == "cpu"
    for check in ("steps_advanced", "steps_advanced_after_chaos", "breakers_recovered", "faults_injected",
                  "no_thread_errors", "moe_recovered"):
        assert report["checks"][check], (check, report)


@pytest.mark.chaos
def test_churn_soak_smoke():
    """3 trainers under the default schedule, one crash-killed mid-chaos and restarted
    against its checkpoint directory: every restarted peer back at the swarm's epoch
    and no unverified state adopted."""
    report = run_soak(n_peers=3, duration=32.0, seed=0, chaos_fraction=0.5, include_moe=False, churn=True,
                      churn_kills=1, device="cpu")
    assert report["checks"]["peers_restarted"], report
    assert report["checks"]["state_recovered"], report
    assert report["digest_failures_adopted"] == 0, report
    assert report["checks"]["digest_failures_adopted_zero"], report
    assert report["checks"]["steps_advanced_after_chaos"], report
    assert report["checks"]["no_thread_errors"], report


def test_the_soak_runs_on_the_card_unless_asked_for_the_cpu():
    """Without a card the default device raises before any swarm starts."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_soak(n_peers=2, duration=1.0)


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_full():
    """4 peers, every named injection point, the whole verdict."""
    report = run_soak(n_peers=4, duration=60.0, seed=0, chaos_fraction=0.6, include_moe=True, device="cpu")
    assert report["ok"], report


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_soak_full_churn():
    """Chaos and seeded churn; the whole verdict, state recovery included."""
    report = run_soak(n_peers=4, duration=60.0, seed=0, chaos_fraction=0.6, include_moe=True, churn=True,
                      device="cpu")
    assert report["ok"], report
