"""Server-side KV-cache decode sessions for pipelined autoregressive inference
(the port of hivemind_tpu/moe/server/decode_session.py).

A client opens a session per block uid: the first call (``reset=True``) prefills
the prompt into fresh caches, and every later call advances one token, so each
generated token costs O(context) instead of the O(context²) recompute of the
whole prefix. Caches live on the backend's device in the block's compact
kv-heads layout (``init_decode_cache`` on the block class), and sessions expire
by TTL and by an LRU cap, so an abandoned client cannot pin device memory.

**Continuous batching** (``decode_async``): single-token steps of session-batch 1
on one uid that arrive within a small window are merged into ONE device call.
The JAX package ``vmap``s its per-session step; here one batched forward runs
instead: x is ``[S, 1, hid]``, the sessions' caches are stacked to
``[S, max_len, kv_heads, head_dim]``, and a per-row index tensor drives the cache
write, the key mask and the RoPE offset (``layers/common.py``). The stack lives for
that one call: each session's new position is copied back into its own cache, so
no session holds a view of the stack.

What the JAX package does and this module does not: it buckets prefill lengths
and merged batch sizes to powers of two, padding with dummy rows, only to bound
its jit cache. Eager PyTorch keeps no compile cache, so every call runs at its
own size; the outputs of real rows are the same (prefill is causal). There is
no ``tracked_jit`` (no jit), and ``shard_decode_cache`` comes with the
multi-GPU slice.

Telemetry, under the JAX package's metric names: the live-session and occupancy
gauges, evictions by reason (``ttl``/``cap``), resets, steps by path
(``direct``: one session's call; ``batched``: merged into one call with
others), and the activation bytes each step copies to and from the device
(``record_transfer``; the caches stay on the device). Steps run on the shared
executor of ``utils/asyncio_utils.py``, whose backlog the watchdog samples.

Weights: a step holds the backend's ``_state_lock`` while it reads the
parameters, since ``ModuleBackend.backward`` updates them in place; int8
backends dequantize inside the step, as their forward does. Every step runs
under ``torch.inference_mode()``, as ``ModuleBackend.forward`` does: caches are
allocated and written in that mode on every path (an inference tensor cannot be
written in place outside it).
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hivemind_tpu_torch.ops.quantized_params import dequantize_tree
from hivemind_tpu_torch.telemetry import REGISTRY as _TELEMETRY
from hivemind_tpu_torch.telemetry.device import record_transfer
from hivemind_tpu_torch.utils.asyncio_utils import run_in_executor, spawn
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the session table is the serving peer's scarcest resource: each session pins
# device cache memory
_SESSIONS = _TELEMETRY.gauge(
    "hivemind_moe_decode_sessions", "live KV-cache decode sessions on this server"
)
_SESSION_OCCUPANCY = _TELEMETRY.gauge(
    "hivemind_moe_decode_session_occupancy",
    "live decode sessions / max_sessions (1.0 = the LRU cap is about to evict)",
)
_EVICTIONS = _TELEMETRY.counter(
    "hivemind_moe_decode_session_evictions_total",
    "decode sessions evicted, by reason (ttl = idle expiry, cap = LRU over max_sessions)",
    ("reason",),
)
_RESETS = _TELEMETRY.counter(
    "hivemind_moe_decode_session_resets_total",
    "decode sessions created or re-prefilled via reset=True",
)
_STEPS = _TELEMETRY.counter(
    "hivemind_moe_decode_steps_total",
    "decode session steps served, by path (direct = per-session call, "
    "batched = merged into one continuous-batch call)",
    ("path",),
)


class _Session:
    __slots__ = ("cache_k", "cache_v", "index", "last_used", "lock")

    def __init__(self, cache_k: torch.Tensor, cache_v: torch.Tensor):
        self.cache_k, self.cache_v = cache_k, cache_v
        self.index = 0
        self.last_used = time.monotonic()
        self.lock = threading.Lock()


def _unknown_session(uid: str, session_id: str) -> KeyError:
    return KeyError(f"unknown or expired decode session {session_id!r} for {uid!r}; restart generation with reset=True")


class DecodeSessionManager:
    """Per-(uid, session_id) KV caches and decode steps for one server.

    :param backends: ``{uid: ModuleBackend}``; uids whose block has
        ``init_decode_cache`` support sessions
    :param max_len: cache capacity per session (prompt + generated tokens)
    :param session_ttl: seconds of inactivity before a session is evicted
    :param max_sessions: LRU cap across all uids
    :param flush_window: how long a drainer waits for other sessions' steps
    :param merge_recency_s: another session counts as a merge candidate only if it
        stepped within this window
    """

    def __init__(self, backends, max_len: int = 256, session_ttl: float = 600.0,
                 max_sessions: int = 64, flush_window: float = 0.002, merge_recency_s: float = 0.25):
        self.backends = backends
        self.max_len, self.session_ttl, self.max_sessions = max_len, session_ttl, max_sessions
        self.flush_window = flush_window
        self.merge_recency_s = merge_recency_s
        self._sessions: Dict[Tuple[str, str], _Session] = {}
        self._lock = threading.Lock()
        self._pending: Dict[str, List] = {}  # uid -> [(future, session, x), ...]
        self._in_flight: Dict[int, int] = {}  # id(session) -> refcount, during _decode_batch
        self._drainers: Dict[str, asyncio.Task] = {}

    def supports(self, uid: str) -> bool:
        backend = self.backends.get(uid)
        return backend is not None and hasattr(backend.module, "init_decode_cache")

    def _evict_locked(self) -> None:
        now = time.monotonic()
        # sessions with a queued or running batched step are pinned: evicting one
        # would orphan its cache, the step would "succeed" against the orphan and
        # the client's next continuation would raise KeyError
        pinned = {id(session) for entries in self._pending.values() for (_future, session, _x) in entries}
        pinned |= set(self._in_flight)
        expired = [key for key, s in self._sessions.items() if now - s.last_used > self.session_ttl and id(s) not in pinned]
        for key in expired:
            del self._sessions[key]
        if expired:
            _EVICTIONS.inc(len(expired), reason="ttl")
        evictable = [key for key in self._sessions if id(self._sessions[key]) not in pinned]
        while len(self._sessions) > self.max_sessions and evictable:
            oldest = min(evictable, key=lambda key: self._sessions[key].last_used)
            evictable.remove(oldest)
            del self._sessions[oldest]
            _EVICTIONS.inc(reason="cap")
        self._sample_gauges_locked()

    def _sample_gauges_locked(self) -> None:
        _SESSIONS.set(len(self._sessions))
        _SESSION_OCCUPANCY.set(round(len(self._sessions) / max(self.max_sessions, 1), 4))

    def _step(self, uid: str, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, index):
        """One block call on the current weights (the caller holds inference mode):
        the direct path's ``index`` is an int, the merged step's a [S] tensor."""
        backend = self.backends[uid]
        with backend._state_lock:
            return torch.func.functional_call(backend.module, dequantize_tree(backend.params),
                                              (x, cache_k, cache_v, index))

    def _batched_step(self, uid: str, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                      index: torch.Tensor):
        """The merged step of several sessions: x ``[S, 1, hid]``, stacked caches
        ``[S, max_len, kv_heads, head_dim]`` and one write index per row."""
        return self._step(uid, x, cache_k, cache_v, index)

    def decode(self, uid: str, session_id: str, x: np.ndarray, reset: bool) -> np.ndarray:
        """One session step: prefill (``reset=True``, chunk = the prompt) or advance
        one token in an existing session. Returns the block output for the chunk.
        Raises ``KeyError`` for a continuation on an unknown or evicted session."""
        if not self.supports(uid):
            raise KeyError(f"expert {uid!r} does not support decode sessions")
        backend = self.backends[uid]
        x = np.asarray(x, np.float32)
        if x.ndim != 3:
            raise ValueError(f"decode input must be [batch, chunk, hid], got {x.shape}")
        batch, new_len = x.shape[0], x.shape[1]
        if new_len > self.max_len:
            raise ValueError(f"chunk of {new_len} exceeds session max_len={self.max_len}")

        key = (uid, session_id)
        with self._lock:
            self._evict_locked()
            session = self._sessions.get(key)
            if reset:
                with torch.inference_mode():
                    caches = backend.module.init_decode_cache(batch, self.max_len, backend.device)
                session = self._sessions[key] = _Session(*caches)
                _RESETS.inc()
                self._sample_gauges_locked()
            elif session is None:
                # never prefill a continuation silently: its output would be garbage
                raise _unknown_session(uid, session_id)
            session.last_used = time.monotonic()

        with session.lock:
            if session.index != 0 and new_len != 1:
                raise ValueError(f"session {session_id!r} already holds {session.index} positions; "
                                 f"only 1-token steps may follow the prefill (got chunk {new_len})")
            if session.index + new_len > self.max_len:
                raise ValueError(f"session {session_id!r} is full ({session.index}/{self.max_len})")
            if session.cache_k.shape[0] != batch:
                raise ValueError(f"session {session_id!r} batch is {session.cache_k.shape[0]}, got {batch}")
            record_transfer(x.nbytes, "host_to_device")
            with torch.inference_mode():
                y, session.cache_k, session.cache_v = self._step(
                    uid, backend._to_device(x), session.cache_k, session.cache_v, session.index)
                out = y.to("cpu").numpy()
            record_transfer(out.nbytes, "device_to_host")
            _STEPS.inc(path="direct")
            session.index += new_len
            # stamped again after the step: a long prefill must not make the session
            # look idle to _concurrent_sessions the moment it returns
            session.last_used = time.monotonic()
            return out

    # ---- continuous batching of single-token steps across sessions ------------

    async def decode_async(self, uid: str, session_id: str, x: np.ndarray, reset: bool):
        """Asyncio entry point: batchable steps (continuation, chunk 1, session
        batch 1) are merged with other sessions' concurrent steps into one device
        call; everything else takes the direct per-session path."""
        loop = asyncio.get_running_loop()
        x = np.asarray(x, np.float32)
        batchable = not reset and x.ndim == 3 and x.shape[0] == 1 and x.shape[1] == 1
        if batchable:
            with self._lock:
                batchable = self._concurrent_sessions(uid)
        if not batchable:
            # a lone decoding stream has nothing to merge: the flush window would
            # only add latency (same-session order is kept by the session lock)
            return await run_in_executor(self.decode, uid, session_id, x, reset)

        future = loop.create_future()
        with self._lock:
            # lookup and enqueue under one lock hold, so the session cannot be
            # evicted while its step is pending
            self._evict_locked()
            session = self._sessions.get((uid, session_id))
            if session is None:
                raise _unknown_session(uid, session_id)
            session.last_used = time.monotonic()
            self._pending.setdefault(uid, []).append((future, session, x))
            if uid not in self._drainers or self._drainers[uid].done():
                self._drainers[uid] = spawn(self._drain(uid), name="decode_session.drain")
        return await future

    def _concurrent_sessions(self, uid: str) -> bool:
        """True when more than one recently active session exists on this uid (so
        waiting the flush window could merge steps). Called under ``self._lock``."""
        now = time.monotonic()
        recent = sum(1 for key, session in self._sessions.items()
                     if key[0] == uid and now - session.last_used < self.merge_recency_s)
        return recent > 1

    async def _drain(self, uid: str) -> None:
        try:
            with self._lock:
                window = self.flush_window if self._concurrent_sessions(uid) else 0.0
            await asyncio.sleep(window)  # 0: one loop tick, so same-tick submitters still merge
        except asyncio.CancelledError:
            # cancelled before the entries were popped: no pins were taken, but the
            # pending futures would strand forever
            with self._lock:
                stranded = self._pending.pop(uid, [])
            for future, _session, _x in stranded:
                if not future.done():
                    future.cancel()
            raise
        with self._lock:
            entries = self._pending.pop(uid, [])
            for _future, session, _x in entries:
                # the eviction pin holds through the device call
                self._in_flight[id(session)] = self._in_flight.get(id(session), 0) + 1
        if not entries:
            return
        # a session must not appear twice in one batch (its cache would fork):
        # later duplicates roll over to the next drain
        seen, batch_entries, rollover = set(), [], []
        for entry in entries:
            if id(entry[1]) in seen:
                rollover.append(entry)
            else:
                seen.add(id(entry[1]))
                batch_entries.append(entry)
        try:
            try:
                results = await run_in_executor(self._decode_batch, uid, batch_entries)
            except Exception as e:
                results = [e] * len(batch_entries)
            for (future, _session, _x), result in zip(batch_entries, results):
                if future.done():
                    continue
                if isinstance(result, Exception):
                    future.set_exception(result)
                else:
                    future.set_result(result)
            # steps that arrived during the batch only enqueued (they saw a live
            # drainer), and the rollover waits too: both need a fresh drainer
            with self._lock:
                if rollover:
                    self._pending.setdefault(uid, []).extend(rollover)
                if self._pending.get(uid):
                    self._drainers[uid] = spawn(self._drain(uid), name="decode_session.drain")
        except asyncio.CancelledError:
            # killed mid-batch (loop shutdown, server stop): nothing will resolve
            # these futures, nor the steps queued meanwhile
            with self._lock:
                stranded = self._pending.pop(uid, [])
            for future, _session, _x in batch_entries + rollover + stranded:
                if not future.done():
                    future.cancel()
            raise
        finally:
            # the pins drop on every exit path: a leaked pin makes a session unevictable
            with self._lock:
                for _future, session, _x in entries:
                    count = self._in_flight.get(id(session), 0) - 1
                    if count > 0:
                        self._in_flight[id(session)] = count
                    else:
                        self._in_flight.pop(id(session), None)

    def _decode_batch(self, uid: str, entries: List) -> List:
        """Run one merged step over ``entries`` [(future, session, x)]; returns one
        result (ndarray or Exception) per entry, in order."""
        backend = self.backends[uid]
        # per-session locks in a fixed order, so the direct path cannot deadlock us
        ordered = sorted(range(len(entries)), key=lambda i: id(entries[i][1]))
        for i in ordered:
            entries[i][1].lock.acquire()
        try:
            results: List = [None] * len(entries)
            live = []
            for i, (_future, session, _x) in enumerate(entries):
                if session.index == 0:
                    results[i] = KeyError(f"decode session for {uid!r} has no prefill yet")
                elif session.index + 1 > self.max_len:
                    results[i] = ValueError(f"decode session is full ({session.index}/{self.max_len})")
                elif session.cache_k.shape[0] != 1:
                    results[i] = ValueError("batched decode requires session batch 1")
                else:
                    live.append(i)
            if not live:
                return results
            sessions = [entries[i][1] for i in live]
            host_x = np.concatenate([entries[i][2] for i in live])
            record_transfer(host_x.nbytes, "host_to_device")
            with torch.inference_mode():
                x = backend._to_device(host_x)
                if len(live) == 1:
                    # one stream: the per-session step, without stacking its caches
                    [session] = sessions
                    y, session.cache_k, session.cache_v = self._step(
                        uid, x, session.cache_k, session.cache_v, session.index)
                else:
                    index = torch.tensor([s.index for s in sessions], dtype=torch.long, device=x.device)
                    y, cache_k, cache_v = self._batched_step(
                        uid, x, torch.cat([s.cache_k for s in sessions]), torch.cat([s.cache_v for s in sessions]),
                        index)
                    # the step wrote one position per row: copy it back into each
                    # session's own cache and let the stack go
                    for row, session in enumerate(sessions):
                        session.cache_k[0, session.index] = cache_k[row, session.index]
                        session.cache_v[0, session.index] = cache_v[row, session.index]
                y = y.to("cpu").numpy()
            record_transfer(y.nbytes, "device_to_host")
            # one session alone is a direct step: nothing was merged
            _STEPS.inc(len(live), path="direct" if len(live) == 1 else "batched")
            now = time.monotonic()
            for row, (i, session) in enumerate(zip(live, sessions)):
                session.index += 1
                session.last_used = now
                results[i] = y[row : row + 1]
            return results
        finally:
            for i in ordered:
                entries[i][1].lock.release()
