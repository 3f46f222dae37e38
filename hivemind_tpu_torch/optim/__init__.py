"""The collaborative optimizer (the port of hivemind_tpu/optim/): ``Optimizer`` and its
gradient and state averagers, the progress tracker, checkpoints, the port's own optax
transforms (``transforms``), and ``SliceOptimizer``, the same semantics on a mesh of
ranks that is one swarm peer."""

from hivemind_tpu_torch.optim.grad_averager import GradientAverager
from hivemind_tpu_torch.optim.grad_scaler import GradScaler
from hivemind_tpu_torch.optim.nan_guard import NaNGuard
from hivemind_tpu_torch.optim.optimizer import Optimizer
from hivemind_tpu_torch.optim.power_sgd_averager import PowerSGDGradientAverager
from hivemind_tpu_torch.optim.slice_optimizer import SliceOptimizer
from hivemind_tpu_torch.optim.recovery import CheckpointError, LocalCheckpointStore, restore_from_local
from hivemind_tpu_torch.optim.progress_tracker import (
    GlobalTrainingProgress,
    LocalTrainingProgress,
    ProgressTracker,
)
from hivemind_tpu_torch.optim.state_averager import TrainingStateAverager
from hivemind_tpu_torch.optim.training_averager import TrainingAverager
