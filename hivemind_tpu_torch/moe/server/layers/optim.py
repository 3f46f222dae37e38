"""Expert-side optimizer helpers (the port of hivemind_tpu/moe/server/layers/optim.py;
upstream: hivemind/moe/server/layers/optim.py ClippingWrapper + lr_schedule.py),
on the port's own optax transforms (hivemind_tpu_torch/optim/transforms.py)."""

from __future__ import annotations

from hivemind_tpu_torch.optim import transforms as optax


def clipped(optimizer: optax.GradientTransformation, clip_norm: float = 1.0) -> optax.GradientTransformation:
    """Global-norm gradient clipping around any optimizer (upstream's ClippingWrapper)."""
    return optax.chain(optax.clip_by_global_norm(clip_norm), optimizer)


def linear_warmup_schedule(peak_lr: float, warmup_steps: int, total_steps: int) -> optax.Schedule:
    """Linear warmup then linear decay (upstream's get_linear_schedule_with_warmup)."""
    return optax.join_schedules(
        [
            optax.linear_schedule(0.0, peak_lr, warmup_steps),
            optax.linear_schedule(peak_lr, 0.0, max(total_steps - warmup_steps, 1)),
        ],
        boundaries=[warmup_steps],
    )


def lamb_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int, clip_norm: float = 1.0):
    """The ALBERT recipe's optimizer: LAMB + warmup schedule + clipping (upstream trains
    ALBERT with Lamb, examples/albert/run_trainer.py)."""
    return clipped(optax.lamb(linear_warmup_schedule(peak_lr, warmup_steps, total_steps)), clip_norm)
