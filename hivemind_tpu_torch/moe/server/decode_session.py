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
own size; the outputs of real rows are the same (prefill is causal). The
session gauges and counters, ``record_transfer`` and ``tracked_jit`` come with
the telemetry slice, and ``shard_decode_cache`` with the multi-GPU one.

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
from hivemind_tpu_torch.utils.asyncio_utils import spawn
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


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
        evictable = [key for key in self._sessions if id(self._sessions[key]) not in pinned]
        while len(self._sessions) > self.max_sessions and evictable:
            oldest = min(evictable, key=lambda key: self._sessions[key].last_used)
            evictable.remove(oldest)
            del self._sessions[oldest]

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
            with torch.inference_mode():
                y, session.cache_k, session.cache_v = self._step(
                    uid, backend._to_device(x), session.cache_k, session.cache_v, session.index)
                out = y.to("cpu").numpy()
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
            return await loop.run_in_executor(None, self.decode, uid, session_id, x, reset)

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
        loop = asyncio.get_running_loop()
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
                results = await loop.run_in_executor(None, self._decode_batch, uid, batch_entries)
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
            with torch.inference_mode():
                x = backend._to_device(np.concatenate([entries[i][2] for i in live]))
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
            now = time.monotonic()
            for row, (i, session) in enumerate(zip(live, sessions)):
                session.index += 1
                session.last_used = now
                results[i] = y[row : row + 1]
            return results
        finally:
            for i in ordered:
                entries[i][1].lock.release()
