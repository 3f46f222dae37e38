"""RemoteSequential: run a model as a CHAIN of remote transformer blocks served by
swarm peers, pipelined model parallelism over the DHT (the port of
hivemind_tpu/moe/client/remote_sequential.py).

Blocks are ordinary experts named ``{prefix}{index}`` ("gpt_block.0", "gpt_block.1",
...): any :class:`~hivemind_tpu_torch.moe.Server` (or a JAX package server) can host
any subset of blocks and declares them in the DHT. The client resolves each index
lazily and chains the blocks' ``RemoteExpert`` calls. ``__call__`` is a
``torch.autograd.Function``, so autograd flows through the WHOLE pipeline, and every
backward RPC also trains the server-side block (ModuleBackend's backward steps its
optimizer). A failed block call triggers re-resolution (a replacement server
re-declaring the same uid takes over transparently).

The autograd node works on float32 host copies, as ``RemoteExpert.__call__`` does:
its backward then runs on the thread that called ``backward()``, not on torch's CUDA
engine thread, so a server in the same process can run its own backward on the card
while this one waits for its RPC."""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from hivemind_tpu_torch.dht import DHT
from hivemind_tpu_torch.moe.client.expert import EXPERT_BREAKERS, RemoteExpert, classify_replicas
from hivemind_tpu_torch.moe.expert_uid import ExpertInfo
from hivemind_tpu_torch.moe.server.dht_handler import get_experts
from hivemind_tpu_torch.p2p import PeerID
from hivemind_tpu_torch.resilience import RetryPolicy
from hivemind_tpu_torch.telemetry.serving import SCORECARDS, is_overload_error
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.loop import get_loop_runner

logger = get_logger(__name__)


class _ResilientBlock(RemoteExpert):
    """A RemoteExpert whose RPCs retry with DHT re-resolution INSIDE forward_np /
    backward_np, so failover covers the backward pass of autograd, not just the
    forward dispatch."""

    def __init__(self, sequential: "RemoteSequential", index: int, info: ExpertInfo):
        super().__init__(info, sequential.p2p,
                         request_compression=sequential.request_compression)
        self._sequential = sequential
        self._index = index

    def _with_retries(self, operation):
        def on_retry(retry_index: int, error: BaseException) -> None:
            logger.warning(
                f"block {self.uid} via {self.peer_id} failed (attempt {retry_index + 1}): {error!r}"
            )
            fresh = self._sequential._resolve_info(self._index, force=True)
            self.expert_info = fresh
            with self._info_lock:
                self._info = None  # schema may differ on the new server

        try:
            return self._sequential.retry_policy.execute_sync(operation, on_retry=on_retry)
        except Exception as last_error:
            raise RuntimeError(f"block {self.uid} failed after retries") from last_error

    def forward_np(self, *xs):
        return self._with_retries(lambda: RemoteExpert.forward_np(self, *xs))

    def backward_np(self, *tensors):
        return self._with_retries(lambda: RemoteExpert.backward_np(self, *tensors))

    @property
    def info(self):
        # the schema fetch at dispatch time must fail over too
        return self._with_retries(lambda: RemoteExpert.info.fget(self))


class RemoteSequential:
    """See module docstring.

    :param prefix: block uid prefix incl. trailing delimiter, e.g. ``"gpt_block."``
    :param num_blocks: pipeline depth; block i is expert ``{prefix}{i}``
    :param update_period: re-resolve a cached block after this many seconds
    :param max_retries: per block call: failures before giving up (each retry
        re-resolves the uid from the DHT first)
    """

    def __init__(
        self,
        dht: DHT,
        prefix: str,
        num_blocks: int,
        *,
        update_period: float = 30.0,
        max_retries: int = 2,
        max_failover_history: int = 4096,
        request_compression: Optional[str] = None,
    ):
        self.dht, self.prefix, self.num_blocks = dht, prefix, num_blocks
        self.update_period, self.max_retries = update_period, max_retries
        # wire-dtype override for every block request; None = negotiate each
        # server's advertised codec
        self.request_compression = request_compression
        # decode failover retains each session's input history for re-prefill; the
        # cap bounds client memory (past it, failover degrades to the pre-r4
        # raise-and-reset behavior for that session). 0 disables retention.
        self.max_failover_history = max_failover_history
        self.p2p = get_loop_runner().run_coroutine(dht.replicate_p2p())
        self._blocks: Dict[int, _ResilientBlock] = {}
        self._infos: Dict[int, ExpertInfo] = {}
        self._resolved_at: Dict[int, float] = {}
        self._span_support: Dict[object, bool] = {}  # peer_id -> server groups spans
        # session_id -> {"route": pinned block handles, "chunks": list of input
        # chunks retained for failover re-prefill (None = over the retention cap),
        # "positions": retained position count}
        self._decode_routes: Dict[str, dict] = {}
        self.max_decode_routes = 256  # oldest pinned routes drop beyond this
        # seeded replica choice across route resolutions: fresh
        # clients spread over the replica set instead of all pinning the first
        # declared server, yet each client's choices replay deterministically
        self._route_rng = random.Random(zlib.crc32(f"{prefix}|{self.p2p.peer_id}".encode()))
        self._lock = threading.Lock()

    @property
    def retry_policy(self) -> RetryPolicy:
        """Every retry loop in this client shares one declared policy:
        short equal-jittered backoff — a replacement server needs a beat to
        re-declare the uid, and synchronized clients must not re-dial in
        lockstep. Derived lazily from ``max_retries`` so changing it (or tests
        building partial instances) stays honored."""
        policy = self.__dict__.get("_retry_policy")
        if policy is None or policy.max_attempts != self.max_retries + 1:
            policy = RetryPolicy(
                max_attempts=self.max_retries + 1,
                base_delay=0.25,
                backoff=2.0,
                max_delay=2.0,
                jitter="equal",
                name="remote_sequential",
            )
            self.__dict__["_retry_policy"] = policy
        return policy

    def __len__(self) -> int:
        return self.num_blocks

    def block_uid(self, index: int) -> str:
        return f"{self.prefix}{index}"

    def _resolve_info(self, index: int, force: bool = False) -> ExpertInfo:
        with self._lock:
            fresh_enough = time.monotonic() - self._resolved_at.get(index, -1e9) < self.update_period
            cached = self._infos.get(index)
            if not force and cached is not None and fresh_enough:
                return cached
        [info] = get_experts(self.dht, [self.block_uid(index)])
        if info is None:
            raise RuntimeError(f"no server declares block {self.block_uid(index)!r}")
        with self._lock:
            self._infos[index] = info
            self._resolved_at[index] = time.monotonic()
        return info

    def _block(self, index: int) -> _ResilientBlock:
        info = self._resolve_info(index)
        with self._lock:
            block = self._blocks.get(index)
            if block is None:
                block = self._blocks[index] = _ResilientBlock(self, index, info)
            elif block.expert_info != info:
                block.expert_info = info  # route refreshed by update_period
                with block._info_lock:
                    block._info = None
            return block

    def _call_block(self, index: int, x: torch.Tensor) -> torch.Tensor:
        return self._block(index)(x)

    def _peer_supports_spans(self, head: RemoteExpert) -> bool:
        """Capability negotiation for mixed swarms: a span-unaware server would run
        only the head block and silently return its output as the whole span's —
        so multi-block groups require the server to advertise span_support."""
        supported = self._span_support.get(head.peer_id)
        if supported is None:
            try:
                supported = bool(head.info.get("span_support"))
            except Exception:
                # transient info failure: assume no spans THIS grouping, but do not
                # cache the negative — a single failed fetch must not disable span
                # grouping for this peer for the process lifetime
                return False
            with self._lock:
                self._span_support[head.peer_id] = supported
        return supported

    def _select_block_replica(
        self, info: ExpertInfo, preferred: Optional[PeerID]
    ) -> ExpertInfo:
        """Pick this block's serving replica: breaker-open replicas
        are avoided (a killed server must drop out of fresh routes instantly),
        the PREVIOUS block's peer is kept when it also hosts this block (span
        grouping — one RPC per server, not per block), then the shared
        replica-health policy (expert.classify_replicas) decides, with a
        seeded-random pick while cold."""
        replicas = info.replica_set
        if len(replicas) == 1:
            return info
        measured, cold, failing, banned = classify_replicas(
            info.uid, replicas, EXPERT_BREAKERS
        )
        live = [replica for _rate, _mean, replica in measured] + cold + failing
        pool = live if live else list(replicas)
        chosen = None
        if preferred is not None:
            for replica in pool:
                if replica.peer_id == preferred:
                    chosen = replica
                    break
        if chosen is None:
            if measured:
                chosen = measured[0][2]
            else:
                chosen = self._route_rng.choice(cold or pool)
        return ExpertInfo(info.uid, chosen.peer_id, chosen.compression, info.replicas)

    def _grouped_range(self, start: int, stop: int, force: bool = False):
        """Resolve blocks [start, stop) and group CONSECUTIVE same-peer blocks into
        spans: each group is one RPC (server chains the blocks — span execution).
        Replicated blocks prefer staying on the previous block's peer so spans
        survive replication (see _select_block_replica)."""
        blocks = []
        preferred: Optional[PeerID] = None
        for index in range(start, stop):
            chosen = self._select_block_replica(
                self._resolve_info(index, force=force), preferred
            )
            blocks.append(
                RemoteExpert(chosen, self.p2p, request_compression=self.request_compression)
            )
            preferred = chosen.peer_id
        groups = []
        for block in blocks:
            if (
                groups
                and groups[-1][0].peer_id == block.peer_id
                and self._peer_supports_spans(groups[-1][0])
            ):
                groups[-1][1].append(block.uid)
            else:
                groups.append((block, [block.uid]))
        for head, uids in groups:
            head.span = uids if len(uids) > 1 else None
        return groups

    def _span_forward(self, start: int, stop: int, x):
        """Each attempt restarts from the ORIGINAL input: a mid-chain failure would
        otherwise retry the whole range on a partially-advanced activation, silently
        double-applying the blocks that already ran (corrupting the autograd
        primal on exactly the failover path the retry exists for)."""
        attempt_counter = [0]

        def one_attempt():
            force = attempt_counter[0] > 0
            attempt_counter[0] += 1
            current = x
            for head, _uids in self._grouped_range(start, stop, force=force):
                current = head.forward_np(current)[0]
            return current

        def on_retry(retry_index: int, error: BaseException) -> None:
            logger.warning(f"span forward [{start}, {stop}) failed (attempt {retry_index + 1}): {error!r}")

        try:
            return self.retry_policy.execute_sync(one_attempt, on_retry=on_retry)
        except Exception as last_error:
            raise RuntimeError(f"span forward [{start}, {stop}) failed after retries") from last_error

    def _span_backward(self, start: int, stop: int, x, grad):
        """Chained backward over the range. With one co-located span the server does
        everything in a single RPC; across several servers the boundary activations
        are recovered with one forward sweep first (the client keeps no residuals).

        Every backward RPC steps the serving blocks' optimizers, so a retry must
        NEVER replay a group whose backward already succeeded — progress is tracked
        as a shrinking [start, remaining) range and only the remainder is retried
        (forward sweeps are side-effect-free and safe to re-run)."""
        state = {"remaining": stop, "grad": grad, "attempt": 0}

        def one_attempt():
            force = state["attempt"] > 0
            state["attempt"] += 1
            if state["remaining"] <= start:
                return state["grad"]
            groups = self._grouped_range(start, state["remaining"], force=force)
            boundary_inputs, current = [], x
            for head, _uids in groups:
                boundary_inputs.append(current)
                if head is not groups[-1][0]:
                    current = head.forward_np(current)[0]
            for (head, uids), block_input in zip(reversed(groups), reversed(boundary_inputs)):
                state["grad"] = head.backward_np(block_input, state["grad"])[0]
                state["remaining"] -= len(uids)  # this group's optimizers have stepped
            return state["grad"]

        def on_retry(retry_index: int, error: BaseException) -> None:
            logger.warning(
                f"span backward [{start}, {state['remaining']}) failed (attempt {retry_index + 1}): {error!r}"
            )

        try:
            return self.retry_policy.execute_sync(one_attempt, on_retry=on_retry)
        except Exception as last_error:
            raise RuntimeError(f"span backward [{start}, {stop}) failed after retries") from last_error

    def __call__(self, x: torch.Tensor, start: int = 0, stop: Optional[int] = None) -> torch.Tensor:
        """Run blocks [start, stop) in order; differentiable end to end. Co-located
        consecutive blocks execute as server-side spans (one RPC per SERVER, not per
        block, both directions), with re-resolution retries inside each call. The
        output is float32 on ``x``'s device; the input gradient takes ``x``'s dtype."""
        stop = stop if stop is not None else self.num_blocks
        if start >= stop:
            return x
        out_schemas = self._block(stop - 1).info["outputs_schema"]
        assert len(out_schemas) == 1, "RemoteSequential chains single-tensor blocks"
        out = _RemoteSpan.apply(self, start, stop, x.to("cpu", torch.float32))
        return out.to(x.device)

    def decode_step(self, x, session_id: str, reset: bool = False):
        """Chain one KV-cache decode-session step through every block: the prefill
        call (``reset=True``) seeds each block's session with the prompt chunk
        [batch, prompt_len, hid], later calls advance a single token
        [batch, 1, hid] — O(context) per token vs the O(context²) right-padded
        ``__call__`` decode. Sessions are STICKY to the peers resolved at prefill
        (the periodic DHT re-resolution must not silently move a session to a
        cache-less peer), but a dead pinned peer fails over TRANSPARENTLY
        (Petals-class behavior): the client retains each session's
        full input history, re-resolves the route, re-prefills every group on the
        replacement peers from that history, and continues the stream — the caller
        never sees a reset, and emitted positions are identical to an
        uninterrupted run (the re-prefill is deterministic)."""
        x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)
        if reset:
            # pin the route with FRESH immutable handles: _ResilientBlock objects
            # are shared and re-pointed in place by the periodic re-resolution, so
            # pinning them would let the route silently move to a cache-less peer.
            # Consecutive blocks on the SAME peer form a span served by one RPC
            # (Petals-style span execution): per-token round-trips = #servers.
            route = self._grouped_range(0, self.num_blocks)
            with self._lock:
                # a reset REUSES the prior state's lock (atomically, under the
                # global lock): an in-flight step on the old state then finishes
                # before this reset's server-side prefill runs, so a failed old
                # step cannot fail over AFTER the reset and clobber the fresh
                # server sessions with the stale history
                prior = self._decode_routes.get(session_id)
                state = {
                    "route": route,
                    "chunks": [],
                    "positions": 0,
                    "lock": prior["lock"] if prior is not None else threading.Lock(),
                }
                self._decode_routes[session_id] = state
                while len(self._decode_routes) > self.max_decode_routes:
                    self._decode_routes.pop(next(iter(self._decode_routes)))  # oldest
        else:
            with self._lock:
                state = self._decode_routes.get(session_id)
            if state is None:
                raise RuntimeError(
                    f"decode session {session_id!r} has no pinned route here; "
                    f"start it with reset=True"
                )
        # the per-session lock serializes concurrent decode_steps on the SAME
        # session (an unguarded concurrent step could fail over with a
        # half-appended chunk list); different sessions still decode in parallel.
        # KV positions are inherently ordered, so serializing is the only sound
        # semantics for same-session concurrency anyway.
        with state["lock"]:
            # history retention: a LIST of chunks (concatenated only at failover, so a
            # long generation costs O(1) per step, not an O(context) recopy), capped by
            # max_failover_history — past the cap, retention stops and a dead peer is
            # a hard error again (restart with reset=True), bounding client memory
            step_appended = False
            if reset:
                if self.max_failover_history and x.shape[1] <= self.max_failover_history:
                    state["chunks"], state["positions"] = [x], x.shape[1]
                else:  # retention disabled (cap 0) or the prompt alone exceeds the cap
                    state["chunks"], state["positions"] = None, 0
            elif state["chunks"] is not None:
                if state["positions"] + x.shape[1] <= self.max_failover_history:
                    state["chunks"].append(x)
                    state["positions"] += x.shape[1]
                    step_appended = True
                else:
                    state["chunks"] = None  # over the cap: failover disabled for this session
            try:
                out = x
                groups_advanced = 0
                for block, span in state["route"]:
                    out = block.decode_np(out, session_id, reset=reset, span=span)
                    groups_advanced += 1
            except Exception as e:
                if is_overload_error(e) and groups_advanced == 0:
                    # a typed shed (fair-share admission / bounded queue) is NOT
                    # a dead peer: the server session is intact and re-prefilling
                    # would only spend more of the very budget that ran out.
                    # Undo this step's history append so the caller can back off
                    # and retry the same step cleanly, and surface the shed.
                    # ONLY valid when no group advanced — a shed deeper in the
                    # pipeline means upstream groups already appended this step
                    # to their KV sessions, and a clean retry would double-feed
                    # them (silent divergence); that case falls through to the
                    # full re-prefill failover below, which rebuilds every
                    # group's cache consistently (or fails loudly).
                    if step_appended:
                        state["chunks"].pop()
                        state["positions"] -= x.shape[1]
                    raise
                if state["chunks"] is None:
                    raise  # history over the retention cap (or disabled): no failover
                history = np.concatenate(state["chunks"], axis=1)
                logger.warning(
                    f"decode session {session_id!r} lost a pinned peer ({e!r}); "
                    f"failing over: re-resolving the route and re-prefilling from "
                    f"{history.shape[1]} retained positions"
                )
                try:
                    out = self._decode_failover(session_id, state, history)
                except Exception:
                    # a FAILED failover leaves surviving servers' caches re-prefilled to
                    # an unknown point and this chunk already in the history: the
                    # session is unusable — forget it so a caller retry gets the
                    # explicit "start with reset=True" error instead of silent
                    # divergence
                    with self._lock:
                        self._decode_routes.pop(session_id, None)
                    raise
                if not reset:
                    out = out[:, -x.shape[1]:]  # the caller expects this step's positions only
        return out

    def _decode_failover(self, session_id: str, state: dict, history) -> np.ndarray:
        """Re-resolve the pipeline and re-prefill EVERY group from the retained
        input history (surviving groups simply rebuild identical caches; the
        replacement peer builds its first). Each group's full-history prefill
        output is the next group's input history, so one sweep both recovers the
        caches and computes the current step. Retries with forced re-resolution
        (a replacement server may take a moment to re-declare the uid)."""

        def one_attempt():
            route = self._grouped_range(0, self.num_blocks, force=True)
            out = history
            for block, span in route:
                out = block.decode_np(out, session_id, reset=True, span=span)
            state["route"] = route
            return np.asarray(out, np.float32)

        def on_retry(retry_index: int, error: BaseException) -> None:
            logger.warning(
                f"decode failover for {session_id!r} failed (attempt {retry_index + 1}): {error!r}"
            )

        try:
            return self.retry_policy.execute_sync(one_attempt, on_retry=on_retry)
        except Exception as last_error:
            raise RuntimeError(
                f"decode session {session_id!r} could not fail over after retries"
            ) from last_error

    def close_decode_session(self, session_id: str) -> None:
        """Forget a pinned decode route and its retained history (the server side
        expires by TTL/LRU)."""
        with self._lock:
            self._decode_routes.pop(session_id, None)

    def block_scorecards(self) -> Dict[str, dict]:
        """Per-block serving scorecards: this client's observed
        success rate / latency quantiles / timeouts / sheds for each pipeline
        block it has called — which block (and therefore which server) is
        degrading the pipeline, from the caller's side."""
        cards = SCORECARDS.export()
        return {
            uid: cards[uid]
            for uid in (self.block_uid(index) for index in range(self.num_blocks))
            if uid in cards
        }

    def decode_capacity(self) -> Optional[int]:
        """The tightest ``decode_max_len`` across the pipeline's current servers
        (each advertises it via rpc_info), or None if a block lacks sessions."""
        capacities = [
            self._block(index).info.get("decode_max_len") for index in range(self.num_blocks)
        ]
        return None if any(c is None for c in capacities) else min(capacities)

    def __getitem__(self, index: int):
        """A callable handle to one block (e.g. for partial pipelines)."""
        if not (0 <= index < self.num_blocks):
            raise IndexError(index)
        return lambda x: self._call_block(index, x)

    def __repr__(self):
        return f"RemoteSequential({self.prefix!r}, {self.num_blocks} blocks)"


class _RemoteSpan(torch.autograd.Function):
    """Blocks [start, stop) of a RemoteSequential as one autograd node on float32
    CPU tensors: forward through ``_span_forward``, backward through
    ``_span_backward`` with the saved input (which steps every served block's
    optimizer, as every backward RPC does)."""

    @staticmethod
    def forward(ctx, sequential: RemoteSequential, start: int, stop: int, x: torch.Tensor):
        ctx.sequential, ctx.start, ctx.stop = sequential, start, stop
        ctx.save_for_backward(x)
        out = sequential._span_forward(start, stop, x.detach().numpy())
        return torch.from_numpy(np.asarray(out, np.float32))

    @staticmethod
    def backward(ctx, grad_output: torch.Tensor):
        (x,) = ctx.saved_tensors
        grad = ctx.sequential._span_backward(ctx.start, ctx.stop, x.detach().numpy(),
                                             grad_output.detach().to(torch.float32).contiguous().numpy())
        return None, None, None, torch.from_numpy(np.asarray(grad, np.float32))
