"""TrainingStateAverager: owns the optimizer and the parameters and periodically
averages them with peers (the port of hivemind_tpu/optim/state_averager.py; upstream:
hivemind/optim/state_averager.py).

The parameters are a mapping keyed like a module's ``named_parameters()``, tensors on
the card that every update changes in place. The optimizer is one of the port's optax
transforms (``hivemind_tpu_torch.optim.transforms``); its state is a tree of tensors on
the same device, updated once per epoch as plain torch ops.

The *averaged view* is what a JAX peer averages: the parameters in the JAX package's
flax layout (``jax.tree_util`` order of the flax tree: keys sorted at every level, Dense
kernels ``[in, out]``, the embedding untransposed; see ``convert.flax_path``), then the
floating optimizer leaves of one or more dimensions in the state's own flatten order,
laid out the same way, then the extras. So a port peer and a JAX peer share one schema
hash and one state blob. The view is built on the card (transposes included) and
crosses to the host in one synchronizing copy; results come back in one copy too.

Writes the caller must not see mid-batch are staged: a background update computes new
parameters into separate tensors (``apply_optimizer_step(stage=True)``) and a background
averaging round may leave its result pending (``do_averaging_round(defer=True)``);
``land_pending()``, called on the training thread, copies them in."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hivemind_tpu_torch.averaging.averager import DecentralizedAverager
from hivemind_tpu_torch.averaging.partition import host_array
from hivemind_tpu_torch.convert import flax_path
from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.optim import transforms
from hivemind_tpu_torch.optim.recovery import _STATE_RESTORES
from hivemind_tpu_torch.optim.transforms import DictKey, GetAttrKey
from hivemind_tpu_torch.telemetry.device import record_transfer
from hivemind_tpu_torch.telemetry.tracing import trace as _tracing_span
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _nested(values: Mapping[Tuple[str, ...], Any]) -> dict:
    """A nested dict from flax paths to values."""
    tree: dict = {}
    for path, value in values.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


class TrainingStateAverager(DecentralizedAverager):
    """Averages model parameters (and optionally optimizer statistics) across peers.

    :param optimizer: a ``hivemind_tpu_torch.optim.transforms.GradientTransformation``
    :param params: the parameters, keyed like ``named_parameters()`` (updated in place)
    :param average_opt_statistics: also average float optimizer-state leaves (e.g.
        Adam's mu/nu) so joining peers inherit momentum
    :param extra_tensors: additional arrays averaged and shared with state downloads
    :param delta_rule_averaging: apply each averaging round's result as a DELTA
        (average − pre-round snapshot) onto the CURRENT state instead of overwriting
        it, so optimizer steps taken concurrently with the round are not clobbered —
        required for delayed/local updates (upstream state_averager.py:73-74)
    """

    def __init__(
        self,
        *,
        dht: DHT,
        optimizer: transforms.GradientTransformation,
        params: Mapping[str, torch.Tensor],
        prefix: str,
        average_opt_statistics: bool = True,
        extra_tensors: Sequence = (),
        delta_rule_averaging: bool = False,
        count_equals_epoch: bool = True,
        **kwargs,
    ):
        self.optax_optimizer = optimizer
        self.delta_rule_averaging = delta_rule_averaging
        self.count_equals_epoch = count_equals_epoch
        self.average_opt_statistics = average_opt_statistics
        self._params: Dict[str, torch.Tensor] = dict(params)
        paths = {name: flax_path(name, tensor.ndim) for name, tensor in self._params.items()}
        self._path_of = {name: path for name, (path, _) in paths.items()}
        self._transposed_at = {path: transposed for path, transposed in paths.values()}
        # the parameter names in the flax tree's flatten order
        self._order: List[str] = [name for _, name in sorted((path, name) for name, path in self._path_of.items())]
        self._staged: Optional[Dict[str, torch.Tensor]] = None  # new parameters not yet copied in
        self._pending_landing: Optional[Tuple[str, List[np.ndarray]]] = None  # ("values" | "delta", host tensors)
        self.opt_state = optimizer.init(self._tree(self._params))
        self.extra_tensors = [np.array(host_array(t), copy=True) for t in extra_tensors]
        self.local_epoch = 0
        self.last_download = None  # the StateDownloadResult that load_full_state_from_peers adopted last
        self._state_lock = threading.Lock()

        opt_leaves = transforms.tree_flatten_with_path(self.opt_state)
        self._averaged_opt_indices = [
            i
            for i, (_, leaf) in enumerate(opt_leaves)
            if average_opt_statistics and leaf.dtype.is_floating_point and leaf.ndim >= 1
        ]
        # whether each averaged optimizer leaf is laid out transposed, as its parameter
        self._opt_transposed = [self._leaf_transposed(opt_leaves[i][0]) for i in self._averaged_opt_indices]
        super().__init__(averaged_tensors=self._host_state_tensors(), dht=dht, prefix=prefix, **kwargs)

    # ------------------------------------------------------------------ state access

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters, keyed like ``named_parameters()``."""
        return self._params

    @property
    def num_params(self) -> int:
        return len(self._order)

    def _tree(self, by_name: Mapping[str, Any]) -> dict:
        return _nested({self._path_of[name]: value for name, value in by_name.items()})

    def _leaf_transposed(self, path: tuple) -> bool:
        return self._transposed_at.get(tuple(key.key for key in path if isinstance(key, DictKey)), False)

    def _current_params(self) -> Dict[str, torch.Tensor]:
        return self._staged if self._staged is not None else self._params

    def _device_views(self) -> Tuple[List[torch.Tensor], List[bool]]:
        """The averaged view's parameters and optimizer leaves, in torch layout, each
        with its transpose flag."""
        current = self._current_params()
        views = [current[name] for name in self._order]
        flags = [self._transposed_at[self._path_of[name]] for name in self._order]
        opt_leaves = transforms.tree_leaves(self.opt_state)
        return views + [opt_leaves[i] for i in self._averaged_opt_indices], flags + self._opt_transposed

    @staticmethod
    def _to_host(views: Sequence[torch.Tensor], flags: Sequence[bool]) -> List[np.ndarray]:
        """Tensors in torch layout as float32 host arrays in the JAX package's layout
        (transposed where ``flags`` says), built on their device and copied off it once."""
        with torch.no_grad():
            flat = torch.cat([(view.T if flipped else view).reshape(-1).to(torch.float32)
                              for view, flipped in zip(views, flags)]) if views else torch.zeros(0)
            host = flat.cpu().numpy()
        arrays, offset = [], 0
        for view, flipped in zip(views, flags):
            shape = tuple(view.T.shape if flipped else view.shape)
            arrays.append(host[offset:offset + int(np.prod(shape))].reshape(shape))
            offset += arrays[-1].size
        record_transfer(host.nbytes, "device_to_host")
        return arrays

    def _host_state_tensors(self) -> List[np.ndarray]:
        """The averageable view: params + chosen optimizer statistics + extras, in the
        JAX package's layout, as float32 host arrays (one copy from the card). Host
        staging is the transport path: every round copies the whole state off the card."""
        with self._state_lock:
            tensors = self._to_host(*self._device_views())
        return tensors + [np.asarray(t, dtype=np.float32) for t in self.extra_tensors]

    def _to_device_views(self, tensors: Sequence, flags: Sequence[bool], device) -> List[torch.Tensor]:
        """Host arrays in the JAX package's layout as tensors on ``device`` in torch
        layout (one copy to the card)."""
        arrays = [np.asarray(host_array(t), dtype=np.float32) for t in tensors]
        flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays]) if arrays else np.zeros(0, np.float32))
        flat = flat.to(device)
        record_transfer(flat.numel() * 4, "host_to_device")
        views, offset = [], 0
        for array, flipped in zip(arrays, flags):
            view = flat[offset:offset + array.size].view(array.shape)
            views.append(view.T if flipped else view)
            offset += array.size
        return views

    def _write_state(self, tensors: Sequence, add: bool = False) -> None:
        """Write (or, with ``add``, add) host tensors of the averaged view into the
        current state, preserving dtypes. Called with the state lock held."""
        views, flags = self._device_views()
        device = views[0].device if views else torch.device("cpu")
        incoming = self._to_device_views(tensors[:len(views)], flags, device)
        with torch.no_grad():
            for target, value in zip(views, incoming):
                if add:
                    target.add_(value.to(target.dtype))
                else:
                    target.copy_(value)
        for extra, tensor in zip(self.extra_tensors, tensors[len(views):]):
            extra_value = np.asarray(host_array(tensor), dtype=np.float32).reshape(extra.shape)
            if add:
                extra += extra_value
            else:
                np.copyto(extra, extra_value)

    def _load_host_state_tensors(self, tensors: Sequence) -> None:
        """Inverse of _host_state_tensors: write averaged values back to the state."""
        n_params, n_opt = len(self._order), len(self._averaged_opt_indices)
        assert len(tensors) >= n_params + n_opt, "state tensor count mismatch"
        with self._state_lock:
            self._write_state(tensors)

    def land_pending(self) -> None:
        """Copy in what a background update or round left staged: new parameters, and a
        pending round's result (values, or a delta onto the current state). Call it on
        the thread that computes with the parameters."""
        with self._state_lock:
            staged, self._staged = self._staged, None
            if staged is not None:
                with torch.no_grad():
                    for name, value in staged.items():
                        self._params[name].copy_(value)
            pending, self._pending_landing = self._pending_landing, None
            if pending is not None:
                kind, tensors = pending
                self._write_state(tensors, add=kind == "delta")

    # ------------------------------------------------------------------ optimization

    def host_gradients(self, grads: Mapping[str, Optional[torch.Tensor]]) -> List[np.ndarray]:
        """Gradients keyed like the parameters (torch layout, any device; None reads as
        zeros) as float32 host arrays in the averaged view's order and layout, in one
        copy from the card."""
        views = [torch.zeros_like(self._params[name]) if grads.get(name) is None else grads[name].detach()
                 for name in self._order]
        return self._to_host(views, [self._transposed_at[self._path_of[name]] for name in self._order])

    def apply_optimizer_step(self, grads: Any, stage: bool = False) -> None:
        """One optimizer update. ``grads`` is a mapping keyed like the parameters (torch
        layout, any device) or a list in the averaged view's order and layout (e.g. the
        averaged-gradient buffers). With ``stage``, the new parameters go to separate
        tensors that :meth:`land_pending` copies in; else they are written in place."""
        with self._state_lock, torch.no_grad():
            current = self._current_params()
            device = next(iter(current.values())).device
            if isinstance(grads, Mapping):
                by_name = {name: torch.as_tensor(grads[name]).to(device, current[name].dtype) for name in self._order}
            else:
                flags = [self._transposed_at[self._path_of[name]] for name in self._order]
                views = self._to_device_views(list(grads), flags, device)
                by_name = {name: view.to(current[name].dtype).contiguous() for name, view in zip(self._order, views)}
            params_tree = self._tree({name: current[name].detach() for name in self._order})
            updates, self.opt_state = self.optax_optimizer.update(self._tree(by_name), self.opt_state, params_tree)
            new_params = dict(zip(self._order, transforms.tree_leaves(transforms.apply_updates(params_tree, updates))))
            if stage:
                self._staged = new_params
            else:
                for name, value in new_params.items():
                    current[name].copy_(value)

    def do_averaging_round(self, timeout: Optional[float] = None, defer: bool = False, **kwargs) -> bool:
        """Stage state to host, average with the group, load it back. Returns True on
        success (upstream state_averager averaging_round path).

        With ``delta_rule_averaging``, the result lands as ``current + (average −
        snapshot)``: local optimizer steps that ran while the round was in flight
        survive (upstream state_averager.py:73-74,595-612). With ``defer`` (a round on a
        background thread while the caller trains on the live parameters), the result
        is left for :meth:`land_pending`."""
        # the round's whole host time: staging, matchmaking, the all-reduce, loading back
        with _tracing_span("state_averager.round", peer=str(self.peer_id), epoch=self.local_epoch) as span:
            averaged = self._averaging_round(timeout, defer, **kwargs)
            if span is not None:
                span.set("averaged", averaged)
            return averaged

    def _averaging_round(self, timeout: Optional[float], defer: bool, **kwargs) -> bool:
        snapshot = self._host_state_tensors()
        with self.get_tensors() as tensors:
            for tensor, fresh in zip(tensors, snapshot):
                tensor.numpy()[...] = fresh
        try:
            result = self.step(timeout=timeout, wait=True, **kwargs)
        except Exception as e:
            logger.warning(f"state averaging round failed: {e!r}")
            return False
        if result is None:
            return False
        with self.get_tensors() as tensors:
            averaged = [t.numpy().copy() for t in tensors]
        if defer and self._staged is None:
            with self._state_lock:
                if self.delta_rule_averaging:
                    self._pending_landing = ("delta", [avg - snap for avg, snap in zip(averaged, snapshot)])
                else:
                    self._pending_landing = ("values", averaged)
        elif self.delta_rule_averaging:
            current = self._host_state_tensors()
            self._load_host_state_tensors([cur + (avg - snap) for cur, avg, snap in zip(current, averaged, snapshot)])
        else:
            self._load_host_state_tensors(averaged)
        return True

    # ------------------------------------------------------------------ schedules

    def replay_schedule_to_epoch(self, epoch: int) -> None:
        """Fast-forward the optimizer's step counters to ``epoch`` so epoch-keyed
        schedules (LR warmup/decay) resume at the right point after adopting a peer's
        params (upstream state_averager.py:700-704 replays scheduler.step() local_epoch
        times; the counters jump directly). Only scalar integer leaves whose field is
        named ``count`` are touched — the optax convention for step counters.

        Valid ONLY under the collaborative convention one optimizer step == one epoch;
        local-updates peers take many steps per epoch, so their counters are preserved
        (gated by ``count_equals_epoch``)."""
        if not self.count_equals_epoch:
            return
        self._set_opt_counts([epoch])

    @staticmethod
    def _is_count_leaf(key_path, leaf) -> bool:
        return bool(
            key_path
            and isinstance(key_path[-1], GetAttrKey)
            and key_path[-1].name == "count"
            and isinstance(leaf, torch.Tensor)
            and not leaf.dtype.is_floating_point
            and leaf.ndim == 0
        )

    def _set_opt_counts(self, values: Sequence[int]) -> None:
        """Overwrite the count leaves in flatten order; a single value is broadcast to
        every counter."""
        with self._state_lock:
            new_leaves, index = [], 0
            for key_path, leaf in transforms.tree_flatten_with_path(self.opt_state):
                if self._is_count_leaf(key_path, leaf):
                    value = values[index] if index < len(values) else values[-1]
                    new_leaves.append(torch.tensor(value, dtype=leaf.dtype, device=leaf.device))
                    index += 1
                else:
                    new_leaves.append(leaf)
            self.opt_state = transforms.tree_unflatten(self.opt_state, new_leaves)

    def _get_opt_counts(self) -> List[int]:
        return [
            int(leaf)
            for key_path, leaf in transforms.tree_flatten_with_path(self.opt_state)
            if self._is_count_leaf(key_path, leaf)
        ]

    # ------------------------------------------------------------------ checkpointing

    def state_dict(self) -> dict:
        """Serializable snapshot: epoch + every averaged tensor (params, chosen opt
        statistics, extras) as host arrays, and the count leaves (upstream
        optimizer.py:719-727)."""
        return {
            "epoch": int(self.local_epoch),
            "tensors": self._host_state_tensors(),
            # counters saved explicitly: local-updates peers take many optimizer
            # steps per epoch, so counts cannot be reconstructed from the epoch
            "opt_counts": self._get_opt_counts(),
        }

    def load_state_dict(self, state: dict) -> None:
        expected = len(self._order) + len(self._averaged_opt_indices) + len(self.extra_tensors)
        tensors = state["tensors"]
        if len(tensors) != expected:
            raise ValueError(f"checkpoint has {len(tensors)} tensors, expected {expected}")
        self._load_host_state_tensors([np.asarray(host_array(t), dtype=np.float32) for t in tensors])
        self.local_epoch = int(state["epoch"])
        counts = state.get("opt_counts")
        if counts:
            self._set_opt_counts(list(counts))
        else:
            self.replay_schedule_to_epoch(self.local_epoch)

    # ------------------------------------------------------------------ state sharing

    async def _get_current_state(self) -> Tuple[Any, List[np.ndarray]]:
        metadata = {"epoch": self.local_epoch}
        return metadata, self._host_state_tensors()

    def load_full_state_from_peers(self, timeout: Optional[float] = None, min_epoch: Optional[int] = None) -> bool:
        """Download params/opt-state/epoch from the swarm and adopt them (upstream
        load_state_from_peers path, state_averager.py:658-698). ``min_epoch`` (normally
        the progress tracker's global epoch) is enforced at the donor's MANIFEST: a donor
        behind it is rejected before any tensor bytes move."""
        future = self._runner.run_coroutine(
            self._load_state_from_peers_async(timeout, min_epoch=min_epoch), return_future=True
        )
        try:
            # small slack over the coroutine's own deadline so the in-loop timeout
            # (which preserves partial verification state) fires first
            result = future.result(None if timeout is None else timeout + 10.0)
        except Exception as e:
            logger.warning(f"state download did not complete: {e!r}")
            return False
        if result is None:
            return False
        expected = len(self._order) + len(self._averaged_opt_indices) + len(self.extra_tensors)
        if len(result.tensors) != expected:
            logger.warning(f"donor sent {len(result.tensors)} tensors, expected {expected}; ignoring")
            return False
        self._load_host_state_tensors(result.tensors)
        self.last_download = result
        # adopted tensors owe nothing to our pre-download quantization errors
        self._wire_residuals.reset()
        # the verified manifest's epoch is authoritative; a legacy (unverified) stream
        # falls back to the msgpack metadata it shipped
        donor_epoch = int(result.epoch)
        if not result.verified and isinstance(result.metadata, dict) and "epoch" in result.metadata:
            donor_epoch = max(donor_epoch, int(result.metadata["epoch"]))
        self.local_epoch = max(self.local_epoch, donor_epoch)
        # int step counters are not averaged tensors: fast-forward them so LR schedules
        # resume at the adopted epoch rather than restarting warmup
        self.replay_schedule_to_epoch(self.local_epoch)
        _STATE_RESTORES.inc(source="swarm")
        logger.info(
            f"adopted peer state at epoch {self.local_epoch} "
            f"({'digest-verified' if result.verified else 'UNVERIFIED legacy stream'})"
        )
        return True
