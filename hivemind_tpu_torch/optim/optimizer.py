"""Optimizer — train collaboratively with an elastic swarm of unreliable peers (the
port of hivemind_tpu/optim/optimizer.py, with every constructor argument and metric
name; upstream: hivemind/optim/optimizer.py:32-790).

PyTorch's idiom on the caller's side, as upstream hivemind: ``step`` reads each
parameter's ``.grad``; an explicit mapping keyed like the parameters (or a list in
their order) works too. The parameters change in place when an epoch's update lands:

    opt = Optimizer(dht=dht, run_id="run", params=model.named_parameters(),
                    optimizer=transforms.adam(1e-3), target_batch_size=4096, batch_size_per_step=32)
    loss = loss_fn(model, batch); loss.backward()
    opt.step(batch_size=32); opt.zero_grad()

The optimizer is one of the port's optax transforms (``optim/transforms.py``). Progress
is measured in virtual "epochs" of ``target_batch_size`` samples accumulated ACROSS the
swarm; when the swarm reaches the target, peers average their accumulated gradients
(weighted by contribution), apply one update each, and advance the epoch — equivalent
to large-batch synchronous training, invariant to swarm size (upstream
optimizer.py:63-69). Gradients and state are averaged in the JAX package's layout, so
port and JAX peers train one model together."""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from hivemind_tpu_torch.averaging.control import AveragingStage, StepControl
from hivemind_tpu_torch.compression import CompressionBase, Float16Compression, NoCompression
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.optim.chronic import ChronicFailureTracking
from hivemind_tpu_torch.optim.grad_averager import GradientAverager
from hivemind_tpu_torch.optim.progress_tracker import ProgressTracker
from hivemind_tpu_torch.optim.recovery import LocalCheckpointStore, restore_from_local
from hivemind_tpu_torch.optim.state_averager import TrainingStateAverager
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.device import STEP_TIMELINE as _STEP_TIMELINE
from hivemind_tpu_torch.telemetry.ledger import LEDGER as _LEDGER
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.timed_storage import get_dht_time

logger = get_logger(__name__)

# a peer that cannot download state adopts the global epoch
# NUMBER while skipping the training that produced it — silently, this turns a
# flaky download path into quiet model divergence; counted so the monitor sees it
_EPOCH_ADOPTED_WITHOUT_STATE = _TELEMETRY.counter(
    "hivemind_optimizer_epoch_adopted_without_state_total",
    "epoch fast-forwards after a failed state download (epoch number adopted, state NOT)",
)


class Optimizer(ChronicFailureTracking):
    """See module docstring.

    :param run_id: unique swarm identifier; peers with the same run_id train together
    :param target_batch_size: global samples per virtual epoch
    :param batch_size_per_step: default samples per local step (overridable per call)
    :param params: the parameters to train, keyed like ``named_parameters()`` (a mapping
        or the iterable of pairs); they are updated in place
    :param optimizer: a ``hivemind_tpu_torch.optim.transforms.GradientTransformation``
    :param use_local_updates: apply updates locally every step and average
        PARAMETERS periodically instead of gradients (asynchronous mode)
    :param average_state_every: average parameters/opt stats every N epochs
    :param auxiliary: no data/gradients of its own; assists group averaging only.
        If no gradient schema is provided, it is bootstrapped from the swarm
        (state download from a running gradient averager) — aux peers need zero
        model knowledge, matching upstream.
    :param delay_optimizer_step: Delayed Parameter Updates — ``step()`` returns as
        soon as the epoch transition is SCHEDULED; gradient averaging and the update
        run on a background thread while the caller computes the next batches on
        one-step-stale parameters (upstream optimizer.py:87-88,131-132 +
        state_averager.py:478-574 background executor). The new parameters are
        computed into separate tensors and copied in at the next ``step()``, so the
        caller's batches never see a half-written update.
    :param delay_grad_averaging: alias that implies delay_optimizer_step (kept for
        upstream API parity; the background task always overlaps both)
    :param delay_state_averaging: run the periodic state-averaging round on a
        background thread (upstream optimizer.py:129-130); its result lands at the
        next ``step()``. Independent of
        delay_optimizer_step — with ``use_local_updates`` this is the canonical
        local-SGD combination (pair with ``delta_rule_averaging`` so local steps
        taken during the round survive). In full DPU mode the whole transition is
        already backgrounded, so the flag adds nothing there.
    :param delta_rule_averaging: apply state-averaging results as deltas so optimizer
        steps running concurrently with the round survive (required for DPU/local
        updates; upstream state_averager.py:73-74)
    :param checkpoint_dir: when set (non-auxiliary peers), keep crash-safe local
        checkpoints there: atomically-published, digest-stamped snapshots saved on
        an epoch cadence and restored at startup, so a machine reboot costs a file
        read instead of a swarm download (restore order: local-verified → swarm →
        fresh)
    :param checkpoint_every: save every N epochs (default 1)
    :param checkpoint_keep_last: checkpoints retained after every save (default 3)
    :param blackbox_dir: when set, arm the process-wide black-box flight
        recorder spooling to this directory (crash-durable msgpack frames of
        finished spans, ledger records and metric snapshots). Arming is
        idempotent per directory.
    """

    def __init__(
        self,
        *,
        dht: DHT,
        run_id: str,
        target_batch_size: int,
        params: Any = None,
        optimizer: Any = None,
        batch_size_per_step: Optional[int] = None,
        matchmaking_time: float = 5.0,
        averaging_timeout: float = 60.0,
        load_state_timeout: float = 60.0,
        average_state_every: int = 1,
        use_local_updates: bool = False,
        delay_optimizer_step: bool = False,
        delay_grad_averaging: bool = False,
        delay_state_averaging: bool = False,
        delta_rule_averaging: bool = False,
        client_mode: bool = False,
        auxiliary: bool = False,
        grad_compression: CompressionBase = Float16Compression(),
        state_averaging_compression: CompressionBase = Float16Compression(),
        target_group_size: Optional[int] = None,
        min_group_size: int = 2,
        grad_averager_factory=None,
        grad_averager_opts: Optional[dict] = None,
        state_averager_opts: Optional[dict] = None,
        tracker_opts: Optional[dict] = None,
        shutdown_timeout: float = 5.0,
        chronic_failure_threshold: int = 5,
        checkpoint_dir: Optional[Any] = None,
        checkpoint_every: int = 1,
        checkpoint_keep_last: int = 3,
        blackbox_dir: Optional[Any] = None,
        verbose: bool = False,
    ):
        assert not (client_mode and auxiliary), "a peer is either a client or an auxiliary, not both"
        assert auxiliary or (params is not None and optimizer is not None), (
            "non-auxiliary peers must provide params and an optimizer"
        )
        self.dht, self.run_id = dht, run_id
        self.target_batch_size = target_batch_size
        self.batch_size_per_step = batch_size_per_step
        self.matchmaking_time, self.averaging_timeout = matchmaking_time, averaging_timeout
        self.load_state_timeout = load_state_timeout
        self.average_state_every = average_state_every
        self.use_local_updates = use_local_updates
        self.delay_optimizer_step = delay_optimizer_step or delay_grad_averaging
        self.delay_grad_averaging = delay_grad_averaging
        self.delay_state_averaging = delay_state_averaging
        assert not (self.delay_optimizer_step and use_local_updates), (
            "delayed updates apply to collaborative (gradient-averaging) mode"
        )
        self.client_mode, self.auxiliary = client_mode, auxiliary
        self.shutdown_timeout = shutdown_timeout
        self.verbose = verbose
        self.scheduled_grads: Optional[StepControl] = None
        self._step_lock = threading.Lock()
        self._update_executor: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="hm_dpu")
            if (self.delay_optimizer_step or delay_state_averaging)
            else None
        )
        self._pending_update: Optional[Future] = None
        # chronic-degradation tracking: every epoch that ends without a successful
        # swarm averaging round counts; after `chronic_failure_threshold` in a row
        # the condition escalates to ERROR and matchmaking backs off exponentially
        # (a persistently failing swarm must not silently train local SGD forever)
        self.chronic_failure_threshold = chronic_failure_threshold
        self._consecutive_failed_rounds = 0
        if blackbox_dir is not None:
            # arm BEFORE the averagers spin up so their first rounds spool too;
            # idempotent per directory (see arm_blackbox)
            from hivemind_tpu_torch.telemetry.blackbox import arm_blackbox

            arm_blackbox(blackbox_dir, peer=str(dht.peer_id))

        averager_common = dict(
            target_group_size=target_group_size,
            min_group_size=min_group_size,
            min_matchmaking_time=matchmaking_time,
            client_mode=client_mode,
            auxiliary=auxiliary,
        )
        self.state_averager: Optional[TrainingStateAverager] = None
        if not auxiliary:
            state_opts = dict(state_averager_opts or {})
            state_opts.setdefault("delta_rule_averaging", delta_rule_averaging)
            # local-updates peers take many optax steps per epoch, so their step
            # counters must never be rewound to the epoch number
            state_opts.setdefault("count_equals_epoch", not use_local_updates)
            self.state_averager = TrainingStateAverager(
                dht=dht,
                optimizer=optimizer,
                params=dict(params),
                prefix=f"{run_id}_state",
                start=True,
                compression=state_averaging_compression,
                state_compression=state_averaging_compression,
                **averager_common,
                **state_opts,
            )
        # crash-safe recovery: restore order is local-verified
        # checkpoint → swarm download (the catch-up path, triggered by the
        # tracker if the checkpoint is stale) → fresh initialization
        self.checkpoint_store: Optional[LocalCheckpointStore] = None
        self.checkpoint_every = max(1, int(checkpoint_every))
        self._checkpoint_executor: Optional[ThreadPoolExecutor] = None
        self._pending_checkpoint: Optional[Future] = None
        if checkpoint_dir is not None and not auxiliary:
            self.checkpoint_store = LocalCheckpointStore(
                checkpoint_dir, keep_last=checkpoint_keep_last
            )
            # serialize+fsync runs off the training thread; the state SNAPSHOT
            # is still taken synchronously so it is epoch-consistent
            self._checkpoint_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hm_ckpt"
            )
            restored_epoch = restore_from_local(self.state_averager, self.checkpoint_store)
            if restored_epoch is not None:
                # donors are ranked by sharing priority = epoch: a restored peer
                # should advertise what it actually holds
                self.state_averager.state_sharing_priority = restored_epoch
        self.grad_averager: Optional[GradientAverager] = None
        if not use_local_updates:
            tensors_like = (
                self.state_averager._host_state_tensors()[: self.state_averager.num_params]
                if self.state_averager is not None
                else []
            )
            if auxiliary:
                # aux peers know nothing about the model: bootstrap the gradient
                # schema from any working peer's averager state (upstream aux mode is
                # schema-free)
                tensors_like = (grad_averager_opts or {}).pop("tensors_like", [])
                if not tensors_like:
                    tensors_like = self._bootstrap_grad_schema(
                        dht, f"{run_id}_grad_averager", timeout=load_state_timeout
                    )
            factory = grad_averager_factory if grad_averager_factory is not None else GradientAverager
            self.grad_averager = factory(
                tensors_like,
                dht=dht,
                prefix=f"{run_id}_grad_averager",
                start=True,
                compression=grad_compression,
                **averager_common,
                **(grad_averager_opts or {}),
            )
        self.tracker = ProgressTracker(
            dht, run_id, target_batch_size, client_mode=client_mode or auxiliary,
            **(tracker_opts or {}),
        )

    # ------------------------------------------------------------------ properties

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters, keyed like ``named_parameters()``."""
        assert self.state_averager is not None
        return self.state_averager.params

    def zero_grad(self) -> None:
        """Clear every parameter's ``.grad`` (``torch.optim.Optimizer.zero_grad``'s default)."""
        for param in self.params.values():
            param.grad = None

    def _gradients(self, grads: Any) -> Optional[Dict[str, Any]]:
        """``grads`` keyed like the parameters: None reads each parameter's ``.grad``
        (None when no parameter has one), a sequence follows the parameters' order."""
        params = self.params
        if grads is None:
            grads = {name: param.grad for name, param in params.items()}
            return None if all(grad is None for grad in grads.values()) else grads
        if isinstance(grads, Mapping):
            return dict(grads)
        grads = list(grads)
        assert len(grads) == len(params), f"got {len(grads)} gradients for {len(params)} parameters"
        return dict(zip(params, grads))

    @property
    def local_epoch(self) -> int:
        return self.state_averager.local_epoch if self.state_averager is not None else self.tracker.global_epoch

    @property
    def ready_to_update_epoch(self) -> bool:
        return self.tracker.ready_to_update_epoch

    # ------------------------------------------------------------------ main entry

    def step(
        self,
        grads: Any = None,
        batch_size: Optional[int] = None,
    ) -> Any:
        """Report progress, accumulate gradients (each parameter's ``.grad`` unless
        ``grads`` is given), and run the collaborative update when the swarm is ready.
        Returns the parameters."""
        # layer-5 span: the whole-step host timeline — a slow step's trace shows
        # WHICH child (catch-up, averaging round, state load) ate the time
        with _tracing_span("optimizer.step", peer=str(self.dht.peer_id), epoch=self.local_epoch):
            if self.auxiliary:
                self._auxiliary_step()
                return None
            assert self.state_averager is not None
            with self._step_lock:
                if self._pending_update is None or self._pending_update.done():
                    self._finish_pending_update()  # a finished background update lands here
                if self._should_load_state_from_peers():
                    self._catch_up_with_swarm()

                batch_size = batch_size if batch_size is not None else (self.batch_size_per_step or 1)
                if self.use_local_updates:
                    return self._local_updates_step(grads, batch_size)
                return self._collaborative_step(grads, batch_size)

    def _collaborative_step(self, grads: Any, batch_size: int) -> Any:
        assert self.grad_averager is not None and self.state_averager is not None
        grads = self._gradients(grads)
        if grads is not None:
            self.grad_averager.accumulate_grads_(self.state_averager.host_gradients(grads), batch_size)
        self.tracker.report_local_progress(self.local_epoch, self.grad_averager.local_samples_accumulated)
        self._maybe_schedule_gradient_averaging()
        if self.tracker.ready_to_update_epoch:
            if self.delay_optimizer_step:
                self._schedule_delayed_epoch_update()
            else:
                self._update_global_epoch()
        return self.state_averager.params

    def _local_updates_step(self, grads: Any, batch_size: int) -> Any:
        """Asynchronous mode: apply updates locally, average parameters periodically
        (upstream use_local_updates, optimizer.py:143-145)."""
        assert self.state_averager is not None
        grads = self._gradients(grads)
        if grads is not None:
            # the compute lane of the step timeline: a delayed state-averaging round overlapping these spans is the overlap
            # efficiency being measured
            with _tracing_span("optimizer.update", peer=str(self.dht.peer_id)):
                self.state_averager.apply_optimizer_step(grads)
        new_samples = self.tracker.local_progress.samples_accumulated + batch_size
        self.tracker.report_local_progress(self.local_epoch, new_samples)
        if self.tracker.ready_to_update_epoch:
            self.state_averager.local_epoch += 1
            if self.local_epoch % self.average_state_every == 0:
                if self.delay_state_averaging and self._update_executor is not None:
                    # overlap the round with further local steps; delta-rule
                    # averaging makes those concurrent steps survive the merge
                    if self._pending_update is None or self._pending_update.done():
                        self._finish_pending_update()
                        self._pending_update = self._update_executor.submit(
                            self.state_averager.do_averaging_round,
                            timeout=self.averaging_timeout,
                            defer=True,
                            scheduled_time=get_dht_time() + self._matchmaking_delay(),
                        )
                else:
                    self.state_averager.do_averaging_round(
                        timeout=self.averaging_timeout,
                        scheduled_time=get_dht_time() + self._matchmaking_delay(),
                    )
            self._maybe_save_checkpoint(self.local_epoch)
            _LEDGER.record_epoch(
                self.local_epoch,
                peer=str(self.dht.peer_id),
                num_peers=self.tracker.global_progress.num_peers,
            )
            self.tracker.update_epoch(self.local_epoch)
        return self.state_averager.params

    def _auxiliary_step(self) -> None:
        """Aux peers keep assisting gradient averaging rounds near epoch ends."""
        assert self.grad_averager is not None
        if self.tracker.ready_to_update_epoch:
            with contextlib.suppress(Exception):
                self.grad_averager.step(
                    weight=0.0, timeout=self.averaging_timeout,
                    scheduled_time=get_dht_time() + self._matchmaking_delay(),
                )
            self.tracker.update_epoch(self.tracker.global_epoch + 1)

    # ------------------------------------------------------------------ internals

    def _maybe_schedule_gradient_averaging(self) -> None:
        """Pre-schedule matchmaking so the group is ready the moment the swarm hits
        the target batch size (upstream optimizer.py:559-567)."""
        assert self.grad_averager is not None
        if self.chronic_averaging_failure:
            # pre-scheduling re-declares in the DHT at full cadence every step; under
            # chronic failure only the (backed-off) step-time path may matchmake
            return
        eta = self.tracker.global_progress.eta_next_epoch - get_dht_time()
        if eta <= self.matchmaking_time * 2 and self._scheduled_control_invalid():
            scheduled_time = get_dht_time() + max(eta, 1e-2)
            self.scheduled_grads = self.grad_averager.schedule_step(
                scheduled_time=scheduled_time, timeout=self.averaging_timeout
            )
            logger.debug(f"pre-scheduled gradient averaging in {eta:.1f}s")

    def _scheduled_control_invalid(self) -> bool:
        control = self.scheduled_grads
        return control is None or control.done() or control.cancelled

    def _update_global_epoch(self) -> None:
        """Average gradients with the swarm, apply one update, advance the epoch
        (upstream _update_global_epoch, optimizer.py:438-509)."""
        assert self.grad_averager is not None and self.state_averager is not None
        # a peer REJOINING after the swarm advanced lands ON the global epoch,
        # not past it (upstream optimizer.py:462)
        next_epoch = max(self.local_epoch + 1, self.tracker.global_epoch)

        averaged_ok: Optional[bool] = None  # None = no round attempted (solo swarm)
        # step timeline: grads are ready HERE; everything between
        # this mark and the update landing is communication to hide
        _STEP_TIMELINE.note_grad_ready(str(self.dht.peer_id))
        if self.tracker.global_progress.num_peers > 1:
            averaged_ok = False
            control = None if self._scheduled_control_invalid() else self.scheduled_grads
            self.scheduled_grads = None
            try:
                # keep the accumulators until the update is applied: if averaging
                # fails we must fall back to the LOCAL gradients, not zeros
                self.grad_averager.step(
                    control=control,
                    weight=self.grad_averager.local_samples_accumulated,
                    timeout=self.averaging_timeout,
                    reset_accumulators=False,
                    scheduled_time=get_dht_time() + self._matchmaking_delay() if control is None else None,
                )
                averaged_ok = True
            except Exception as e:
                logger.warning(f"gradient averaging failed ({e!r}); applying local gradients")
        if not averaged_ok:
            # fall back to local gradients (upstream optimizer.py:632-639)
            self.grad_averager.load_accumulators_into_averager_()

        with self.grad_averager.use_averaged_gradients() as averaged_grads:
            with _tracing_span("optimizer.update", peer=str(self.dht.peer_id), epoch=next_epoch):
                self.state_averager.apply_optimizer_step(list(averaged_grads))
        self.grad_averager.reset_accumulated_grads_()
        self._finish_epoch_transition(next_epoch, averaged_ok)

    # chronic counter/backoff/log members come from ChronicFailureTracking

    def _finish_epoch_transition(self, next_epoch: int, averaged_ok: Optional[bool]) -> None:
        """``averaged_ok``: True/False for an attempted swarm round, None when no
        round was attempted (num_peers <= 1 — a solo peer is healthy, not failing)."""
        assert self.state_averager is not None
        self._record_round_outcome(averaged_ok)
        self.state_averager.local_epoch = next_epoch
        if self.average_state_every and next_epoch % self.average_state_every == 0 and self.tracker.global_progress.num_peers > 1:
            self.state_averager.do_averaging_round(
                timeout=self.averaging_timeout,
                scheduled_time=get_dht_time() + self._matchmaking_delay(),
            )
        self.state_averager.state_sharing_priority = next_epoch
        # checkpoint AFTER the state-averaging round so the file holds the
        # swarm-averaged tensors this epoch actually produced
        self._maybe_save_checkpoint(next_epoch)
        # attribution ledger: close this epoch's record AFTER both
        # averaging rounds, so the rounds-since-last-epoch rollup covers them
        _LEDGER.record_epoch(
            next_epoch,
            peer=str(self.dht.peer_id),
            averaged_ok=averaged_ok,
            num_peers=self.tracker.global_progress.num_peers,
        )
        self.tracker.update_epoch(next_epoch)
        if self.verbose:
            logger.info(
                f"transitioned to epoch {next_epoch} "
                f"(averaged={averaged_ok}, peers={self.tracker.global_progress.num_peers})"
            )

    # ------------------------------------------------------------------ delayed (DPU)

    def _schedule_delayed_epoch_update(self) -> None:
        """Stage this epoch's gradients and hand the transition to the background
        thread; the caller keeps training on one-step-stale parameters
        (upstream DPU, optimizer.py:87-88 + state_averager.py:478-574)."""
        assert self.grad_averager is not None and self._update_executor is not None
        if self._pending_update is not None and not self._pending_update.done():
            return  # previous transition still in flight; keep accumulating
        self._finish_pending_update()

        # stage NOW: later microbatches belong to the next epoch and must not leak
        # into the in-flight round (shared buffers hold this epoch's local average,
        # which doubles as the fallback if swarm averaging fails)
        self.grad_averager.load_accumulators_into_averager_()
        _STEP_TIMELINE.note_grad_ready(str(self.dht.peer_id))
        # weight 0 is correct for a peer with nothing accumulated: its zero buffers
        # must not dilute the group average (matches the synchronous path)
        weight = float(self.grad_averager.local_samples_accumulated)
        self.grad_averager.reset_accumulated_grads_()
        control = None if self._scheduled_control_invalid() else self.scheduled_grads
        self.scheduled_grads = None
        next_epoch = max(self.local_epoch + 1, self.tracker.global_epoch)
        self._pending_update = self._update_executor.submit(
            self._delayed_epoch_update, control, weight, next_epoch
        )

    def _delayed_epoch_update(self, control, weight: float, next_epoch: int) -> None:
        assert self.grad_averager is not None and self.state_averager is not None
        averaged_ok: Optional[bool] = None  # None = no round attempted (solo swarm)
        if self.tracker.global_progress.num_peers > 1:
            averaged_ok = False
            try:
                self.grad_averager.step(
                    control=control,
                    weight=weight,
                    timeout=self.averaging_timeout,
                    load_accumulators=False,
                    scheduled_time=get_dht_time() + self._matchmaking_delay() if control is None else None,
                )
                averaged_ok = True
            except Exception as e:
                logger.warning(f"delayed gradient averaging failed ({e!r}); applying local gradients")
        with self.grad_averager.use_averaged_gradients() as averaged_grads:
            with _tracing_span("optimizer.update", peer=str(self.dht.peer_id), epoch=next_epoch):
                # into separate tensors: the caller computes with the live ones meanwhile
                self.state_averager.apply_optimizer_step(list(averaged_grads), stage=True)
        self._finish_epoch_transition(next_epoch, averaged_ok)

    def _finish_pending_update(self, timeout: Optional[float] = None) -> None:
        """Surface exceptions from a completed (or awaited) background transition, and
        land what it staged (on the caller's thread)."""
        pending, self._pending_update = self._pending_update, None
        if pending is None:
            return
        try:
            pending.result(timeout)
        except Exception as e:
            # the whole background transition died (not just its averaging round):
            # count it toward chronic degradation and escalate past the threshold
            self._record_round_outcome(False)
            log = logger.error if self.chronic_averaging_failure else logger.warning
            log(f"background epoch transition failed "
                f"({self._consecutive_failed_rounds} consecutive): {e!r}")
        if self.state_averager is not None:
            self.state_averager.land_pending()

    def _should_load_state_from_peers(self) -> bool:
        """One-epoch grace (upstream optimizer.py:655-673): a peer overlapping its
        own transition (DPU) or trailing by exactly one epoch will catch up by itself;
        only a wider gap warrants downloading a peer's state."""
        if self._pending_update is not None and not self._pending_update.done():
            return False  # our own transition is mid-flight, not a straggler
        # one-epoch grace for EVERY mode (upstream optimizer.py:654-672): the
        # first peer to see enough samples transitions and restarts the count —
        # a peer observing global == local + 1 is witnessing normal network
        # asynchrony and must transition itself (the tracker reports it ready),
        # not discard its progress and download state
        return self.local_epoch < self.tracker.global_epoch - 1

    def _catch_up_with_swarm(self) -> None:
        """We are behind the swarm: adopt a peer's state
        (upstream _should_load_state_from_peers + load_state_from_peers)."""
        assert self.state_averager is not None
        global_epoch = self.tracker.global_epoch
        logger.info(
            f"local epoch {self.local_epoch} is behind the swarm ({global_epoch}); "
            f"downloading state"
        )
        # min_epoch: donors serving state older than the tracker's published
        # progress are rejected at their manifest, never adopted. The
        # one-epoch grace mirrors the protocol's own transition asynchrony: the
        # peer whose report SET global_epoch may have crashed, leaving every
        # live donor one epoch behind — adopting global-1 still lands us in the
        # normal grace band (we transition ourselves next ready step), whereas
        # zero grace would reject the whole swarm and fast-forward with STALE
        # local params, which is strictly worse
        if self.state_averager.load_full_state_from_peers(
            timeout=self.load_state_timeout, min_epoch=max(0, global_epoch - 1)
        ):
            if self.grad_averager is not None:
                self.grad_averager.reset_accumulated_grads_()
            # a crash right after catch-up should not redo the download
            self._maybe_save_checkpoint(self.local_epoch, force=True)
        else:
            # could not download: adopt the epoch NUMBER to avoid re-triggering
            # forever — but this peer now claims training it never did, so say
            # it loudly and count it: chronic occurrences
            # mean the swarm's recovery path is broken, not merely flaky
            _EPOCH_ADOPTED_WITHOUT_STATE.inc()
            logger.error(
                f"state download failed; fast-forwarding local epoch "
                f"{self.local_epoch} -> {self.tracker.global_epoch} WITHOUT adopting state "
                f"(parameters keep their pre-catch-up values)"
            )
            self.state_averager.local_epoch = self.tracker.global_epoch

    def _maybe_save_checkpoint(self, epoch: int, force: bool = False) -> None:
        """Publish a local checkpoint on the configured epoch cadence (crash-safe:
        recovery.LocalCheckpointStore). The epoch-consistent snapshot is captured
        here; serialize+write+fsync runs on the checkpoint executor so the
        training step is never blocked on disk (``force`` — shutdown / just after
        a catch-up — saves synchronously for durability). A save still in flight
        when the next cadence hits is not queued behind: that epoch is skipped.
        Failures never fail the step — a peer with a broken disk keeps training,
        loudly."""
        if self.checkpoint_store is None or self.state_averager is None:
            return
        if not force and epoch % self.checkpoint_every != 0:
            return
        if self._pending_checkpoint is not None and self._pending_checkpoint.done():
            pending, self._pending_checkpoint = self._pending_checkpoint, None
            try:
                pending.result(0)
            except Exception as e:
                logger.warning(f"background checkpoint save failed: {e!r}")
        if not force and self._pending_checkpoint is not None:
            # decided BEFORE the snapshot: copying the full state just to throw
            # it away would hold the state lock on the training thread for nothing
            logger.debug(f"checkpoint save at epoch {epoch} skipped: previous save in flight")
            return
        if force and self._pending_checkpoint is not None:
            # a forced save must not run concurrently with the background writer:
            # two interleaved save()/prune() passes could sweep each other's
            # temp files, and the forced save must end up the durable one
            pending, self._pending_checkpoint = self._pending_checkpoint, None
            try:
                pending.result(60)
            except Exception as e:
                logger.warning(f"background checkpoint save failed: {e!r}")
        try:
            state = self.state_averager.state_dict()
        except Exception as e:
            logger.warning(f"checkpoint snapshot at epoch {epoch} failed: {e!r}")
            return

        def _write() -> None:
            with _tracing_span("state_sync.checkpoint", epoch=epoch):
                self.checkpoint_store.save(state)

        if force or self._checkpoint_executor is None:
            try:
                _write()
            except Exception as e:
                logger.warning(f"checkpoint save at epoch {epoch} failed: {e!r}")
        else:
            self._pending_checkpoint = self._checkpoint_executor.submit(_write)

    @staticmethod
    def _bootstrap_grad_schema(dht: DHT, prefix: str, timeout: Optional[float]):
        """Learn the gradient tensor schema from any peer's running gradient averager
        (its shared state download); retries until the swarm has one."""
        import time as time_module

        from hivemind_tpu_torch.averaging.averager import DecentralizedAverager

        deadline = get_dht_time() + (timeout or 60.0)
        while True:
            with contextlib.suppress(Exception):
                result = DecentralizedAverager.download_state_from_swarm(
                    dht, prefix, timeout=min(15.0, timeout or 15.0)
                )
                if result is not None and result[1]:
                    logger.info(f"bootstrapped gradient schema: {len(result[1])} tensors")
                    return [np.zeros(tuple(t.shape), np.float32) for t in result[1]]
            if get_dht_time() >= deadline:
                raise RuntimeError(
                    f"auxiliary peer could not learn the gradient schema from the swarm "
                    f"under {prefix!r} within {timeout}s (no peer sharing state yet?)"
                )
            time_module.sleep(1.0)

    def load_state_from_peers(self, timeout: Optional[float] = None) -> bool:
        assert self.state_averager is not None
        return self.state_averager.load_full_state_from_peers(timeout=timeout or self.load_state_timeout)

    # ------------------------------------------------------------------ checkpointing

    def state_dict(self) -> dict:
        """User-level checkpoint with the epoch embedded
        (upstream optimizer.py:719-727)."""
        assert self.state_averager is not None
        return self.state_averager.state_dict()

    def load_state_dict(self, state: dict) -> None:
        """Restore a checkpoint: tensors + epoch, with LR schedules replayed to the
        restored epoch (upstream state_averager.py:700-704)."""
        assert self.state_averager is not None
        self.state_averager.load_state_dict(state)
        if self.grad_averager is not None:
            self.grad_averager.reset_accumulated_grads_()

    def shutdown(self) -> None:
        if self._pending_update is not None:
            self._finish_pending_update(timeout=self.averaging_timeout)
        if self._update_executor is not None:
            self._update_executor.shutdown(wait=True)
        if self.state_averager is not None:
            self.state_averager.land_pending()
        # final checkpoint: a clean shutdown restores exactly where it stopped
        # (drain the background writer first so the forced save is the newest)
        if self._checkpoint_executor is not None:
            self._checkpoint_executor.shutdown(wait=True)
            self._pending_checkpoint = None
            self._checkpoint_executor = None
        self._maybe_save_checkpoint(self.local_epoch, force=True)
        self.tracker.shutdown()
        if self.scheduled_grads is not None:
            self.scheduled_grads.cancel()
        if self.grad_averager is not None:
            self.grad_averager.shutdown()
        if self.state_averager is not None:
            self.state_averager.shutdown()

    def __repr__(self):
        return (
            f"Optimizer(run_id={self.run_id!r}, epoch={self.local_epoch}, "
            f"local_updates={self.use_local_updates}, client={self.client_mode}, aux={self.auxiliary})"
        )
