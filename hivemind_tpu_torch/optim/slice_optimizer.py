"""SliceOptimizer: the whole collaborative ``Optimizer`` semantics — target_batch_size
epochs, swarm gradient averaging, the progress tracker, periodic state averaging and
``load_state_from_peers`` — on a mesh of ranks that is ONE swarm peer (the port of
hivemind_tpu/optim/slice_optimizer.py; upstream: hivemind/optim/optimizer.py:32-790).

Division of labor:

- **Every rank** (all ranks call every method at the same points): holds its model's
  parameters (its shards of the tensor-parallel leaves), its share of the accumulated
  gradients on its device, and the optimizer's state; joins the collective staging,
  broadcast and update phases.
- **Rank 0** (the network process) alone owns the DHT, the ``ProgressTracker``,
  matchmaking (with the pre-scheduled gradient rounds), the butterfly all-reduce and
  state sharing. The other ranks never build a networking object.

The device side, in PyTorch's idiom:

- **Gradients accumulate on the device.** ``step()`` adds each parameter's ``.grad``
  (the rank's share of the batch's gradient: the model's mesh loss leaves shares that
  sum over ``dp`` and ``sp`` to the gradient of the whole batch) times the batch size
  into a float32 accumulator. Nothing crosses to the host until the epoch ends; then
  the shares are summed over ``dp`` and ``sp`` on the devices and each leaf's regions
  are pulled into rank 0's host mirrors (``MeshTensorBridge``), in the JAX package's
  flax layout.
- **The update is collective.** Rank 0 broadcasts the final gradient (the swarm's
  average, or the slice's own where the round failed) one leaf at a time, and every
  rank applies the same optimizer update to the whole leaves it keeps: the parameters
  (its model's own tensors where a leaf is not sharded; a whole copy beside its shards
  where it is) and the optimizer's state. Every rank computes the same numbers from the
  same inputs, so the ranks stay identical.
- **Decisions are broadcast, not re-derived.** Whether to catch up, whether the swarm is
  ready for an epoch and whether averaging succeeded are known only on rank 0; a small
  decision vector goes out each step so every rank takes the same branch. A failure of
  the network process sets the vector's error flag, and every rank raises together
  instead of waiting forever in a collective.

Wire compatibility: the slice matchmakes under the host peers' prefixes
(``{run_id}_grad_averager``, ``{run_id}_state``) with their schemas (the flax layout of
``convert.flax_path``, the optimizer's floating leaves after the parameters), so port
slices, JAX slices, port peers and JAX peers share one swarm. It advertises the slice's
aggregate egress (the base rate times its hosts).

``delay_grad_averaging`` overlaps the swarm gradient round with training: the round runs
on a background thread of rank 0 while every rank keeps stepping into a fresh
accumulator; its completion is announced through the decision broadcast and the update
lands collectively at the next step boundary, one epoch stale. ``max_broadcast_skip``
thins the decision broadcast far from a boundary: rank 0 announces how many steps may
skip it and every rank counts the same number down.

Not supported, as in the JAX package: ``use_local_updates`` (use ``SliceAverager``) and
the aux/client modes (a slice is a full peer)."""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.averaging.control import StepControl
from hivemind_tpu_torch.compression import CompressionBase, Float16Compression
from hivemind_tpu_torch.convert import flax_path
from hivemind_tpu_torch.optim import transforms
from hivemind_tpu_torch.optim.chronic import ChronicFailureTracking
from hivemind_tpu_torch.optim.grad_averager import GradientAverager
from hivemind_tpu_torch.optim.progress_tracker import ProgressTracker
from hivemind_tpu_torch.optim.state_averager import TrainingStateAverager, _nested
from hivemind_tpu_torch.optim.transforms import DictKey, GetAttrKey
from hivemind_tpu_torch.parallel.ici import MeshTensorBridge
from hivemind_tpu_torch.parallel.mesh import Mesh, params_shardings
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

_C_SKIPPED_STEPS = _TELEMETRY.counter(
    "hivemind_optim_skipped_broadcast_steps_total",
    "steps that skipped the per-step decision broadcast (thinning)",
).labels()
_C_EPOCH_TRANSITIONS = _TELEMETRY.counter(
    "hivemind_optim_epoch_transitions_total", "slice epoch transitions", ("kind",)
)
_C_POISONED_ROUNDS = _TELEMETRY.counter(
    "hivemind_optim_poisoned_averager_rounds_total",
    "delayed rounds whose thread outlived its join timeout, poisoning the grad averager",
).labels()

_DATA_AXES = ("dp", "sp")  # the axes over which ranks hold different data
_DECISION_SLOTS = 8


class _SliceStateAverager(DecentralizedAverager):
    """State-sharing endpoint of a slice: serves the staged state mirrors with the
    slice's current epoch as metadata (mirrors are refreshed at every epoch transition,
    so downloads are at most one epoch stale)."""

    def __init__(self, *args, epoch_fn, **kwargs):
        self._epoch_fn = epoch_fn
        super().__init__(*args, **kwargs)

    async def _get_current_state(self) -> Tuple[Any, List[np.ndarray]]:
        return {"epoch": int(self._epoch_fn())}, self._snapshot_tensors()


class SliceOptimizer(ChronicFailureTracking):
    """See module docstring.

    :param mesh: the mesh spanning every rank of the slice
    :param params: this rank's parameters, keyed like ``named_parameters()`` (a mapping
        or the iterable of pairs); updated in place
    :param optimizer: a ``hivemind_tpu_torch.optim.transforms.GradientTransformation``
        (the same on every peer)
    :param dht_factory: zero-argument callable building the network rank's DHT; called
        ONLY on rank 0
    :param run_id: swarm identifier, the host peers' ``run_id``
    :param target_batch_size: global samples per virtual epoch (swarm-wide)
    :param batch_size_per_step: default GLOBAL samples per ``step`` (every rank passes
        the same number: the slice's microbatch, not its block)
    :param average_state_every: a parameter/optimizer-state round every N epochs
    :param average_opt_statistics: also average the floating optimizer leaves (as the
        host peers must, or the state schemas differ)
    :param delay_grad_averaging: run the swarm gradient round on a background thread of
        rank 0 while the slice keeps stepping; its update lands one epoch stale
    :param max_broadcast_skip: how many steps rank 0 may let skip the decision
        broadcast while the next epoch is far; 0 disables thinning
    """

    _chronic_peer_noun = "slice"

    def __init__(
        self,
        *,
        mesh: Mesh,
        params: Any,
        optimizer: transforms.GradientTransformation,
        dht_factory,
        run_id: str,
        target_batch_size: int,
        batch_size_per_step: Optional[int] = None,
        average_state_every: int = 1,
        average_opt_statistics: bool = True,
        delay_grad_averaging: bool = False,
        max_broadcast_skip: int = 8,
        matchmaking_time: float = 5.0,
        averaging_timeout: float = 60.0,
        load_state_timeout: float = 60.0,
        grad_compression: CompressionBase = Float16Compression(),
        state_averaging_compression: CompressionBase = Float16Compression(),
        target_group_size: Optional[int] = None,
        min_group_size: int = 2,
        bandwidth: Optional[float] = None,
        grad_averager_factory=None,
        chronic_failure_threshold: int = 5,
        verbose: bool = False,
        **averager_opts,
    ):
        self.mesh = mesh
        self.run_id = run_id
        self.target_batch_size = target_batch_size
        self.batch_size_per_step = batch_size_per_step
        self.average_state_every = max(int(average_state_every), 1)
        self.delay_grad_averaging = delay_grad_averaging
        self.max_broadcast_skip = max(int(max_broadcast_skip), 0)
        self.matchmaking_time = matchmaking_time
        self.averaging_timeout = averaging_timeout
        self.load_state_timeout = load_state_timeout
        self.verbose = verbose
        self.bridge = MeshTensorBridge(mesh)
        self.process_index = mesh.rank
        self.is_network_process = self.bridge.is_network_rank
        self._optimizer = optimizer
        self._step_lock = threading.Lock()

        # -------- device state (every rank) --------
        self._params: Dict[str, torch.Tensor] = dict(params)
        self._shardings = params_shardings(self._params, mesh)
        paths = {name: flax_path(name, tensor.ndim) for name, tensor in self._params.items()}
        self._path_of = {name: path for name, (path, _) in paths.items()}
        self._transposed_at = {path: transposed for path, transposed in paths.values()}
        self._order: List[str] = [name for _, name in sorted((path, name) for name, path in self._path_of.items())]
        # the whole leaves the update runs on: a replicated leaf is the parameter itself
        self._full: Dict[str, torch.Tensor] = {name: self._whole(name) for name in self._order}
        self.opt_state = optimizer.init(self._tree(self._full))
        opt_leaves = transforms.tree_flatten_with_path(self.opt_state)
        # the host peers' selection rule (TrainingStateAverager): floating, ndim >= 1
        self._averaged_opt_indices = [
            i for i, (_, leaf) in enumerate(opt_leaves)
            if average_opt_statistics and leaf.dtype.is_floating_point and leaf.ndim >= 1
        ]
        self._opt_transposed = [self._leaf_transposed(opt_leaves[i][0]) for i in self._averaged_opt_indices]
        self._accum = {name: torch.zeros_like(self._params[name], dtype=torch.float32) for name in self._order}
        self._samples = 0
        self.local_epoch = 0
        self.scheduled_grads: Optional[StepControl] = None
        # delayed-round state, the same on every rank (set and cleared only at
        # collective steps, so whether a round is pending needs no collective)
        self._pending: Optional[dict] = None
        self._bg_thread: Optional[threading.Thread] = None  # rank 0 only
        self._bg_outcome: Optional[dict] = None  # rank 0 only
        # a delayed-round thread that outlived its join timeout still owns the grad
        # averager's tensors: until it is confirmed dead the averager is POISONED
        self._poisoned_bg_thread: Optional[threading.Thread] = None  # rank 0 only
        self._skip_remaining = 0
        self._deferred_network_error: Optional[BaseException] = None
        self._step_time_ema: Optional[float] = None
        self._last_step_time: Optional[float] = None
        self.chronic_failure_threshold = chronic_failure_threshold
        self._consecutive_failed_rounds = 0

        # -------- networking (rank 0 only) --------
        self.dht = None
        self.grad_averager: Optional[DecentralizedAverager] = None
        self.state_averager: Optional[_SliceStateAverager] = None
        self.tracker: Optional[ProgressTracker] = None
        if self.is_network_process:
            self.dht = dht_factory()
            common = dict(
                dht=self.dht,
                start=True,
                target_group_size=target_group_size,
                min_group_size=min_group_size,
                min_matchmaking_time=matchmaking_time,
                bandwidth=bandwidth if bandwidth is not None else 1.0e8 * max(mesh.num_hosts, 1),
                **averager_opts,
            )
            grad_templates = [np.zeros(self._flax_shape(name), np.float32) for name in self._order]
            # a GradientAverager factory (class or functools.partial of one) skips its
            # host accumulators: the slice accumulates on the devices and stages directly
            factory = grad_averager_factory if grad_averager_factory is not None else DecentralizedAverager
            factory_class = factory if isinstance(factory, type) else getattr(factory, "func", None)
            extra_opts = ({"accumulate_grads_on_host": False}
                          if isinstance(factory_class, type) and issubclass(factory_class, GradientAverager) else {})
            self.grad_averager = factory(grad_templates, prefix=f"{run_id}_grad_averager", compression=grad_compression,
                                         **extra_opts, **common)
            self.state_averager = _SliceStateAverager(
                self._state_to_host(), prefix=f"{run_id}_state", compression=state_averaging_compression,
                state_compression=state_averaging_compression, epoch_fn=lambda: self.local_epoch, **common,
            )
            self.tracker = ProgressTracker(self.dht, run_id, target_batch_size)

    # ------------------------------------------------------------------ device state

    def _whole(self, name: str) -> torch.Tensor:
        """The whole leaf ``name`` on this rank: the parameter itself, or its shards
        gathered along the sharded axes (a copy kept beside the shards)."""
        param, sharding = self._params[name], self._shardings[name]
        if sharding.is_replicated:
            return param
        with torch.no_grad():
            flax = sharding.flax_view(param.detach())
            for dim, axis in enumerate(sharding.axes(flax.ndim)):
                if axis is not None and self.mesh.shape[axis] > 1:
                    flax = torch.cat(self.mesh.all_gather(flax.contiguous(), axis), dim=dim)
            return sharding.flax_view(flax).contiguous()

    def _flax_shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self._shardings[name].flax_view(self._full[name]).shape)

    def _tree(self, by_name: Mapping[str, Any]) -> dict:
        return _nested({self._path_of[name]: value for name, value in by_name.items()})

    def _leaf_transposed(self, path: tuple) -> bool:
        return self._transposed_at.get(tuple(key.key for key in path if isinstance(key, DictKey)), False)

    def _state_views(self) -> Tuple[List[torch.Tensor], List[bool]]:
        """The averaged view's tensors (whole parameters in flatten order, then the
        chosen optimizer leaves) in torch layout, each with its transpose flag."""
        views = [self._full[name] for name in self._order]
        flags = [self._transposed_at[self._path_of[name]] for name in self._order]
        opt_leaves = transforms.tree_leaves(self.opt_state)
        return views + [opt_leaves[i] for i in self._averaged_opt_indices], flags + self._opt_transposed

    def _state_to_host(self) -> List[np.ndarray]:
        """The averaged view as float32 host arrays in the JAX package's layout (from
        this rank's own whole state: every rank holds the same)."""
        with torch.no_grad():
            return TrainingStateAverager._to_host(*self._state_views())

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """This rank's parameters, keyed like ``named_parameters()``."""
        return self._params

    def zero_grad(self) -> None:
        for param in self._params.values():
            param.grad = None

    def _gradients(self, grads: Any) -> Optional[Dict[str, Optional[torch.Tensor]]]:
        if grads is None:
            grads = {name: param.grad for name, param in self._params.items()}
            return None if all(grad is None for grad in grads.values()) else grads
        if isinstance(grads, Mapping):
            return dict(grads)
        grads = list(grads)
        assert len(grads) == len(self._params), f"got {len(grads)} gradients for {len(self._params)} parameters"
        return dict(zip(self._params, grads))

    def _broadcast(self, value: Optional[np.ndarray], shape) -> np.ndarray:
        """Rank 0's small float32 array on every rank (a host copy)."""
        return self.bridge.broadcast_array(value, shape, torch.device("cpu")).numpy()

    # ------------------------------------------------------------------ main entry

    @property
    def ready_to_update_epoch(self) -> bool:
        """Meaningful on the network rank; the others learn it through the broadcast."""
        return bool(self.tracker is not None and self.tracker.ready_to_update_epoch)

    def step(self, grads: Any = None, batch_size: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Accumulate one (global) microbatch of gradient shares (each parameter's
        ``.grad`` unless ``grads`` is given); when the swarm reaches
        ``target_batch_size``, run the collective epoch transition (or, with
        ``delay_grad_averaging``, launch the swarm round and adopt it at a later step).
        Every rank calls this at the same point with the same ``batch_size``. Returns
        the parameters."""
        with self._step_lock:
            batch_size = batch_size if batch_size is not None else (self.batch_size_per_step or 1)
            grads = self._gradients(grads)
            if grads is not None:
                with torch.no_grad():
                    for name, grad in grads.items():
                        if grad is not None:
                            self._accum[name].add_(grad.detach().to(torch.float32) * batch_size)
                self._samples += batch_size
            self._observe_step_time()

            # a thinned step: every rank counts the same announced number down, so the
            # ranks stay in lockstep with no collective; rank 0 still does its own
            # networking, and an error there waits for the next broadcast step
            if self._skip_remaining > 0:
                self._skip_remaining -= 1
                _C_SKIPPED_STEPS.inc()
                if self.is_network_process and self._deferred_network_error is None:
                    try:
                        self.tracker.report_local_progress(self.local_epoch, self._samples)
                        if self._pending is None:
                            self._maybe_schedule_gradient_averaging()
                    except BaseException as e:
                        self._deferred_network_error = e
                return self._params

            # rank 0 decides, the others adopt the decision. Slot 4 is an error flag:
            # when rank 0's networking raises, it still broadcasts, so every rank raises
            # together; slots 5-6 announce a pending round's completion; 7 the skip count
            in_flight = self._pending is not None
            network_error: Optional[BaseException] = None
            decision = np.zeros(_DECISION_SLOTS, np.float32)
            if self.is_network_process:
                try:
                    if self._deferred_network_error is not None:
                        network_error, self._deferred_network_error = self._deferred_network_error, None
                        raise network_error
                    self.tracker.report_local_progress(self.local_epoch, self._samples)
                    if not in_flight:
                        self._maybe_schedule_gradient_averaging()
                    # one-epoch grace (upstream optimizer.py:654-672): only a 2+ gap downloads
                    catch_up = self.local_epoch < self.tracker.global_epoch - 1
                    ready = self.tracker.ready_to_update_epoch
                    round_done = round_ok = 0.0
                    if in_flight and self._bg_thread is not None:
                        if ready and self._bg_thread.is_alive():
                            # the NEXT boundary arrived with the round in flight: staleness
                            # is capped at one epoch, so wait the round out
                            self._bg_thread.join(timeout=self.averaging_timeout + 30.0)
                        if not self._bg_thread.is_alive():
                            round_done = 1.0
                            round_ok = 1.0 if (self._bg_outcome or {}).get("ok") else 0.0
                    elif in_flight:
                        round_done, round_ok = 1.0, 0.0  # a pending round with no thread: adopt now
                    decision = np.asarray([
                        1.0 if catch_up else 0.0, 1.0 if ready else 0.0, float(self.tracker.global_epoch),
                        float(self.tracker.global_progress.num_peers), 0.0, round_done, round_ok,
                        float(self._suggest_skip(catch_up, ready, in_flight)),
                    ], np.float32)
                except BaseException as e:
                    network_error = e
                    decision = np.asarray([0.0, 0.0, -1.0, -1.0, 1.0, 0.0, 0.0, 0.0], np.float32)
            decision = self._broadcast(decision, (_DECISION_SLOTS,))
            if decision[4] >= 0.5:
                if network_error is not None:
                    raise network_error
                raise RuntimeError("the slice's network process failed during its decision phase; "
                                   "raising on every rank together (rank 0's traceback has the cause)")
            catch_up, ready = decision[0] >= 0.5, decision[1] >= 0.5
            global_epoch, num_peers = int(decision[2]), int(decision[3])
            round_done, round_ok = decision[5] >= 0.5, decision[6] >= 0.5
            self._skip_remaining = max(int(decision[7]), 0)

            if catch_up:
                # local_epoch already counts a launched delayed round, so being behind
                # is genuine: drop the pending round and download
                self._discard_pending()
                self._collective_catch_up(global_epoch)
                return self._params
            if in_flight:
                if round_done:
                    self._finish_delayed_epoch(round_ok)
                return self._params
            if ready:
                if self.delay_grad_averaging and num_peers > 1:
                    self._begin_delayed_epoch(num_peers, global_epoch)
                else:
                    self._collective_epoch_update(num_peers, global_epoch)
            return self._params

    def _observe_step_time(self) -> None:
        """EMA of the wall time between ``step()`` calls (sizes the skip)."""
        now = get_dht_time()
        if self._last_step_time is not None:
            dt = max(now - self._last_step_time, 1e-6)
            self._step_time_ema = dt if self._step_time_ema is None else 0.8 * self._step_time_ema + 0.2 * dt
        self._last_step_time = now

    def _suggest_skip(self, catch_up: bool, ready: bool, in_flight: bool) -> int:
        """How many upcoming steps may skip the decision broadcast (rank 0). Never near
        a boundary, with a round pending, when behind, or while chronically failing."""
        if (self.max_broadcast_skip <= 0 or catch_up or ready or in_flight or self.chronic_averaging_failure
                or self._step_time_ema is None):
            return 0
        progress = self.tracker.global_progress
        eta = progress.eta_next_epoch - get_dht_time()
        # broadcast every step inside the pre-scheduling window, with a 2x step-time margin
        if eta <= max(self.matchmaking_time * 2, 4 * self._step_time_ema):
            return 0
        # the ETA extrapolates the swarm's past rate; the samples still missing cannot
        # be outrun that way, and our own steps may cover at most half of them
        per_step = max(int(self.batch_size_per_step or 1), 1)
        remaining_samples = max(progress.target_batch_size - progress.samples_accumulated, 0)
        steps_to_target = int(remaining_samples // (2 * per_step))
        return min(self.max_broadcast_skip, int(eta / (2 * self._step_time_ema)), steps_to_target)

    # ------------------------------------------------------------------ gradients

    def _stage_gradients(self) -> Optional[List[np.ndarray]]:
        """COLLECTIVE: the accumulated shares summed over ``dp`` and ``sp`` on the
        devices and pulled into rank 0's host arrays (flax layout), normalized by the
        samples; None on the other ranks."""
        leaves = [self._accum[name] for name in self._order]
        shardings = [self._shardings[name] for name in self._order]
        scratch = self.bridge.gather_reduced_to_host(leaves, shardings, reduce_axis=_DATA_AXES, op="sum")
        if scratch is not None:
            inv = np.float32(1.0 / max(self._samples, 1))
            for mirror in scratch:
                mirror *= inv
        return scratch

    def _reset_accumulator(self) -> None:
        for accum in self._accum.values():
            accum.zero_()
        self._samples = 0

    # ------------------------------------------------------------------ delayed rounds

    def _begin_delayed_epoch(self, num_peers: int, global_epoch: int = 0) -> None:
        """COLLECTIVE: stage this epoch's gradients to rank 0, remember the pending round,
        reset the accumulator (training goes on into the next epoch), ADVANCE the epoch
        (the epoch counts the launched round; only the update is delayed), and on rank 0
        launch the swarm round on a background thread."""
        _C_EPOCH_TRANSITIONS.inc(kind="delayed_launch")
        scratch = self._stage_gradients()
        self._pending = {"scratch": scratch, "num_peers": num_peers}
        # weight 0 for a peer with nothing accumulated: its zeros must not dilute the mean
        weight = float(self._samples)
        self._reset_accumulator()
        self.local_epoch = max(self.local_epoch + 1, global_epoch)  # a rejoining slice lands ON the global epoch
        if not self.is_network_process:
            return
        self.tracker.update_epoch(self.local_epoch)
        control = None if self._scheduled_control_invalid() else self.scheduled_grads
        self.scheduled_grads = None
        outcome: dict = {"ok": False}
        self._bg_outcome = outcome

        def run_round() -> None:
            # the adoption step reads scratch only after joining this thread
            outcome["ok"] = self._run_swarm_round(scratch, weight, control)

        self._bg_thread = threading.Thread(target=run_round, name="slice-delayed-round", daemon=True)
        self._bg_thread.start()

    def _finish_delayed_epoch(self, round_ok: bool) -> None:
        """COLLECTIVE: adopt the background round's outcome (rank 0's scratch holds the
        group average, or the slice's own gradients) and land the update. The current
        accumulator (the next epoch's progress) is untouched."""
        pending, self._pending = self._pending, None
        if self.is_network_process and self._bg_thread is not None:
            self._bg_thread.join(timeout=5.0)  # the decision said done
        self._bg_thread = self._bg_outcome = None
        self._apply_epoch_tail(pending["scratch"], bool(round_ok), pending["num_peers"],
                               reset_accumulator=False, advance_epoch=False)

    def _discard_pending(self) -> None:
        """Drop an in-flight delayed round (the catch-up path replaces the state it would
        update). Rank 0 waits the thread out; one that survives the join POISONS the
        grad averager until it is confirmed dead."""
        if self._pending is None:
            return
        self._pending = None
        if self.is_network_process and self._bg_thread is not None:
            self._bg_thread.join(timeout=self.averaging_timeout + 30.0)
            if self._bg_thread.is_alive():
                self._poisoned_bg_thread = self._bg_thread
                _C_POISONED_ROUNDS.inc()
                logger.error(
                    f"a discarded delayed averaging round did not terminate within "
                    f"{self.averaging_timeout + 30.0:.0f}s; the grad averager is POISONED — swarm gradient "
                    f"rounds degrade to local gradients until the round thread is confirmed dead (see "
                    f"hivemind_optim_poisoned_averager_rounds_total)"
                )
        self._bg_thread = self._bg_outcome = None

    def _grad_averager_poisoned(self) -> bool:
        thread = self._poisoned_bg_thread
        if thread is None:
            return False
        if thread.is_alive():
            return True
        self._poisoned_bg_thread = None
        logger.warning("the poisoned delayed-round thread has terminated; grad averager buffers are safe to reuse again")
        return False

    # ------------------------------------------------------------------ scheduling

    def _maybe_schedule_gradient_averaging(self) -> None:
        """Pre-schedule matchmaking so the group is formed when the swarm hits the
        target (upstream optimizer.py:559-567). Rank 0 only, no collective."""
        if self.chronic_averaging_failure or self._grad_averager_poisoned():
            return
        eta = self.tracker.global_progress.eta_next_epoch - get_dht_time()
        if eta <= self.matchmaking_time * 2 and self._scheduled_control_invalid():
            scheduled_time = get_dht_time() + max(eta, 1e-2)
            if isinstance(self.grad_averager, GradientAverager):
                self.scheduled_grads = self.grad_averager.schedule_step(scheduled_time=scheduled_time,
                                                                        timeout=self.averaging_timeout)
            else:
                self.scheduled_grads = self.grad_averager.step(scheduled_time=scheduled_time,
                                                               timeout=self.averaging_timeout,
                                                               require_trigger=True, wait=False)
            logger.debug(f"pre-scheduled slice gradient averaging in {eta:.1f}s")

    def _scheduled_control_invalid(self) -> bool:
        control = self.scheduled_grads
        return control is None or control.done() or control.cancelled

    # ------------------------------------------------------------------ epoch transition

    def _run_swarm_round(self, scratch: List[np.ndarray], weight: float, control) -> bool:
        """Rank 0 only; the one gradient round of the synchronous and delayed paths:
        ``scratch`` into the shared tensors, the round, and on success the group average
        back INTO ``scratch``. Never raises (every failure is False, so the broadcasts
        keep the ranks in lockstep); a claimed control is cancelled on failure."""
        try:
            if self._grad_averager_poisoned():
                if control is not None and not control.done():
                    with contextlib.suppress(Exception):
                        control.cancel()
                return False
            with self.grad_averager.get_tensors() as tensors:
                for tensor, fresh in zip(tensors, scratch):
                    tensor.numpy()[...] = fresh
            if isinstance(self.grad_averager, GradientAverager):
                result = self.grad_averager.step(
                    control=control, weight=weight, timeout=self.averaging_timeout, load_accumulators=False,
                    scheduled_time=get_dht_time() + self._matchmaking_delay() if control is None else None,
                )
            elif control is not None:
                control.weight = weight
                control.allow_allreduce()
                result = control.result(self.averaging_timeout)
            else:
                result = self.grad_averager.step(weight=weight, timeout=self.averaging_timeout,
                                                 scheduled_time=get_dht_time() + self._matchmaking_delay())
            if result is None:
                return False
            with self.grad_averager.get_tensors() as tensors:
                for mirror, tensor in zip(scratch, tensors):
                    np.copyto(mirror, tensor.numpy())
            return True
        except Exception as e:
            if control is not None and not control.done():
                with contextlib.suppress(Exception):
                    control.cancel()
            logger.warning(f"slice gradient averaging failed ({e!r}); applying local gradients")
            return False

    def _collective_epoch_update(self, num_peers: int, global_epoch: int = 0) -> None:
        """The slice's ``_update_global_epoch`` (upstream optimizer.py:438-509): stage →
        swarm round (rank 0) → the flag → the collective update → the state round."""
        _C_EPOCH_TRANSITIONS.inc(kind="synchronous")
        scratch = self._stage_gradients()  # rank 0's copy doubles as the local fallback
        averaged_ok: Optional[bool] = None  # None: no round attempted (a solo swarm)
        if num_peers > 1:
            averaged_ok = False
            if self.is_network_process:
                # claim the pre-scheduled control before the round, so a failure cancels it
                control = None if self._scheduled_control_invalid() else self.scheduled_grads
                self.scheduled_grads = None
                averaged_ok = self._run_swarm_round(scratch, float(self._samples), control)
            flag = self._broadcast(np.asarray([1.0 if averaged_ok else 0.0], np.float32), (1,))
            averaged_ok = bool(flag[0] >= 0.5)
        self._apply_epoch_tail(scratch, averaged_ok, num_peers, reset_accumulator=True, global_epoch=global_epoch)

    def _apply_epoch_tail(self, scratch: Optional[List[np.ndarray]], averaged_ok: Optional[bool], num_peers: int,
                          reset_accumulator: bool, advance_epoch: bool = True, global_epoch: int = 0) -> None:
        """The shared end of every epoch transition: rank 0's final gradients go to every
        rank leaf by leaf and every rank runs the same update; then the round's outcome
        is recorded, the state mirrors refreshed, the periodic state round run, and the
        epoch advanced. On the delayed path the accumulator already holds the next
        epoch's progress and the epoch was counted at launch."""
        next_epoch = max(self.local_epoch + 1, global_epoch) if advance_epoch else self.local_epoch
        grads = {}
        for index, name in enumerate(self._order):
            value = self.bridge.broadcast_array(None if scratch is None else scratch[index], self._flax_shape(name))
            grads[name] = self._shardings[name].flax_view(value)
        self._apply_update(grads)
        if reset_accumulator:
            self._reset_accumulator()
        # the round's outcome first (upstream optimizer.py:384-388): the state phase's
        # matchmaking delay must see the recovered counter
        self._record_round_outcome(averaged_ok)
        self._collective_state_phase(next_epoch, num_peers)
        self.local_epoch = next_epoch
        if self.is_network_process:
            self.state_averager.state_sharing_priority = next_epoch
            if advance_epoch:
                self.tracker.update_epoch(next_epoch)
        if self.verbose:
            logger.info(f"[rank {self.process_index}] slice transitioned to epoch {next_epoch} "
                        f"(averaged={averaged_ok}, peers={num_peers})")

    def _apply_update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One optimizer update of the whole leaves (torch layout gradients), written
        into the parameters: in place, and into this rank's shards of sharded leaves."""
        with torch.no_grad():
            params_tree = self._tree({name: self._full[name].detach() for name in self._order})
            grads_tree = self._tree({name: grads[name].to(self._full[name].dtype) for name in self._order})
            updates, self.opt_state = self._optimizer.update(grads_tree, self.opt_state, params_tree)
            new_params = transforms.tree_leaves(transforms.apply_updates(params_tree, updates))
            for name, value in zip(self._order, new_params):
                self._write_param(name, value)

    def _write_param(self, name: str, value: torch.Tensor) -> None:
        self._full[name].copy_(value)
        if self._full[name] is not self._params[name]:
            self._params[name].copy_(self._shardings[name].shard(self._full[name]))

    def _refresh_state_mirrors(self) -> Optional[List[np.ndarray]]:
        """Rank 0: the current state into the state averager's mirrors, so downloads
        serve fresh tensors; returns its host copies (None on the other ranks)."""
        if not self.is_network_process:
            return None
        state_scratch = self._state_to_host()
        try:
            with self.state_averager.get_tensors() as tensors:
                for tensor, fresh in zip(tensors, state_scratch):
                    tensor.numpy()[...] = fresh
        except Exception as e:  # the mirrors stay one epoch staler; raising would strand the other ranks
            logger.warning(f"failed to refresh state mirrors: {e!r}")
        return state_scratch

    def _collective_state_phase(self, next_epoch: int, num_peers: int) -> None:
        """Refresh the state mirrors; every ``average_state_every`` epochs also average
        the state with the swarm and adopt the result on every rank."""
        state_scratch = self._refresh_state_mirrors()
        if not (num_peers > 1 and next_epoch % self.average_state_every == 0):
            return
        ok = False
        if self.is_network_process:
            try:
                ok = self.state_averager.step(timeout=self.averaging_timeout,
                                              scheduled_time=get_dht_time() + self._matchmaking_delay()) is not None
                if ok:
                    with self.state_averager.get_tensors() as tensors:
                        for mirror, tensor in zip(state_scratch, tensors):
                            np.copyto(mirror, tensor.numpy())
            except Exception as e:
                ok = False
                logger.warning(f"slice state averaging failed: {e!r}")
        flag = self._broadcast(np.asarray([1.0 if ok else 0.0], np.float32), (1,))
        if flag[0] >= 0.5:
            self._adopt_state_tensors(state_scratch)

    # ------------------------------------------------------------------ catch-up

    def _state_shapes(self) -> List[Tuple[int, ...]]:
        views, flags = self._state_views()
        return [tuple(view.T.shape if flipped else view.shape) for view, flipped in zip(views, flags)]

    def _collective_catch_up(self, global_epoch: int) -> bool:
        """Behind the swarm: rank 0 downloads a donor's state, then every rank adopts it
        (upstream optimizer.py:655-717). The epoch is broadcast on both outcomes, so every
        rank lands on the same one. Returns True when a donor's state was adopted."""
        _C_EPOCH_TRANSITIONS.inc(kind="catch_up")
        header = np.asarray([0.0, float(global_epoch)], np.float32)
        tensors: Optional[List[np.ndarray]] = None
        if self.is_network_process:
            logger.info(f"slice epoch {self.local_epoch} is behind the swarm ({global_epoch}); downloading state")
            shapes = self._state_shapes()
            try:
                result = self.state_averager.load_state_from_peers(timeout=self.load_state_timeout)
            except Exception as e:
                logger.warning(f"state download failed: {e!r}")
                result = None
            if result is not None:
                metadata, downloaded = result
                # count AND sizes before ok=1: a mismatched donor failing mid-adoption
                # would leave the other ranks waiting in a leaf broadcast
                if len(downloaded) == len(shapes) and all(int(np.prod(shape)) == t.numel()
                                                          for t, shape in zip(downloaded, shapes)):
                    tensors = [np.asarray(t, np.float32).reshape(shape) for t, shape in zip(downloaded, shapes)]
                    epoch = int(metadata["epoch"]) if isinstance(metadata, dict) and "epoch" in metadata else global_epoch
                    header = np.asarray([1.0, float(max(epoch, global_epoch))], np.float32)
                else:
                    logger.warning(f"donor state does not match our schema ({len(downloaded)} tensors vs "
                                   f"{len(shapes)} expected); ignoring")
        header = self._broadcast(header, (2,))
        ok, adopted_epoch = bool(header[0] >= 0.5), int(header[1])
        if not ok:
            # every rank adopts the BROADCAST epoch, so the slice stops re-triggering
            self.local_epoch = max(self.local_epoch, adopted_epoch)
            return False
        self._adopt_checkpoint(tensors, adopted_epoch)
        logger.info(f"[rank {self.process_index}] slice adopted swarm state at epoch {adopted_epoch}")
        return True

    def _adopt_checkpoint(self, tensors: Optional[List[np.ndarray]], epoch: int) -> None:
        """COLLECTIVE adoption tail of catch-up and checkpoint restore: write rank 0's
        tensors into every rank's state, fast-forward the counters and the epoch, reset
        the accumulation and restage the state mirrors."""
        self._adopt_state_tensors(tensors)
        self._set_opt_counts(epoch)
        self.local_epoch = epoch
        self._reset_accumulator()
        if self.is_network_process:
            self._refresh_state_mirrors()
            self.state_averager.state_sharing_priority = epoch
            self.tracker.report_local_progress(epoch, 0)

    def _adopt_state_tensors(self, host_tensors: Optional[List[np.ndarray]]) -> None:
        """Rank 0's host values of the averaged view (flax layout), one leaf at a time,
        into every rank's parameters and chosen optimizer leaves."""
        views, flags = self._state_views()
        shapes = self._state_shapes()
        with torch.no_grad():
            for index, (view, flipped, shape) in enumerate(zip(views, flags, shapes)):
                value = self.bridge.broadcast_array(None if host_tensors is None else host_tensors[index], shape)
                value = (value.T if flipped else value).to(view.dtype)
                if index < len(self._order):
                    self._write_param(self._order[index], value)
                else:
                    view.copy_(value)

    def _validate_checkpoint(self, tensors: List[np.ndarray]) -> None:
        shapes = self._state_shapes()
        if len(tensors) != len(shapes) or any(int(np.asarray(t).size) != int(np.prod(shape))
                                               for t, shape in zip(tensors, shapes)):
            raise ValueError(f"checkpoint tensors do not match the state schema ({len(tensors)} tensors vs "
                             f"{len(shapes)} leaves)")

    def _set_opt_counts(self, epoch: int) -> None:
        """Fast-forward the optimizer's integer step counters to ``epoch`` (one update ==
        one epoch; upstream state_averager.py:700-704)."""
        new_leaves = []
        for key_path, leaf in transforms.tree_flatten_with_path(self.opt_state):
            is_count = bool(key_path and isinstance(key_path[-1], GetAttrKey) and key_path[-1].name == "count"
                            and isinstance(leaf, torch.Tensor) and not leaf.dtype.is_floating_point and leaf.ndim == 0)
            new_leaves.append(torch.tensor(epoch, dtype=leaf.dtype, device=leaf.device) if is_count else leaf)
        self.opt_state = transforms.tree_unflatten(self.opt_state, new_leaves)

    # ------------------------------------------------------------------ lifecycle

    def state_dict(self) -> dict:
        """A checkpoint with the epoch embedded (upstream optimizer.py:719-727): the
        averaged view's tensors as host arrays, the same on every rank (each rank holds
        the whole state). Takes the step lock, so it never sees a half-done epoch."""
        with self._step_lock:
            return {"epoch": int(self.local_epoch), "tensors": self._state_to_host()}

    def load_state_dict(self, state: dict) -> None:
        """Restore a checkpoint (COLLECTIVE: every rank passes the same one). An
        in-flight delayed round is discarded: its gradients belong to the replaced state."""
        tensors = [np.asarray(t, np.float32) for t in state["tensors"]]
        self._validate_checkpoint(tensors)
        with self._step_lock:
            self._discard_pending()
            self._adopt_checkpoint(tensors, int(state["epoch"]))

    def force_epoch_transition(self, num_peers: int = 1) -> None:
        """Run the collective epoch transition NOW with what has accumulated (tests,
        drills, a drain before shutdown). COLLECTIVE. A pending delayed round is finished
        first, so no staged epoch is lost."""
        with self._step_lock:
            if self._pending is not None:
                ok = 0.0
                if self.is_network_process and self._bg_thread is not None:
                    self._bg_thread.join(timeout=self.averaging_timeout + 30.0)
                    if not self._bg_thread.is_alive() and (self._bg_outcome or {}).get("ok"):
                        ok = 1.0
                flag = self._broadcast(np.asarray([ok], np.float32), (1,))
                self._finish_delayed_epoch(bool(flag[0] >= 0.5))
            self._collective_epoch_update(num_peers)

    def load_state_from_peers(self, timeout: Optional[float] = None) -> bool:
        """An explicit collective state download (every rank calls it)."""
        del timeout  # the network rank uses self.load_state_timeout
        with self._step_lock:
            self._discard_pending()
            epoch_target = self.local_epoch
            if self.tracker is not None:
                epoch_target = max(epoch_target, self.tracker.global_epoch)
            return self._collective_catch_up(epoch_target)

    def shutdown(self) -> None:
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=self.averaging_timeout + 30.0)
            self._bg_thread = None
        if self.tracker is not None:
            self.tracker.shutdown()
        if self.scheduled_grads is not None:
            self.scheduled_grads.cancel()
        if self.grad_averager is not None:
            self.grad_averager.shutdown()
        if self.state_averager is not None:
            self.state_averager.shutdown()
        if self.dht is not None:
            self.dht.shutdown()

    def __repr__(self):
        return (f"SliceOptimizer(run_id={self.run_id!r}, epoch={self.local_epoch}, rank={self.process_index}, "
                f"network={self.is_network_process})")
