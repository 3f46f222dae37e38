"""The user-facing DHT facade (the port's copy of hivemind_tpu/dht/dht.py).

The DHTNode runs on the port's process-wide event-loop thread (``utils/loop.py``),
and sync callers get blocking results or concurrent futures. ``run_coroutine``
executes an arbitrary coroutine *on the DHT's loop* with direct access to the
DHTNode. The DHT holds no tensors and takes no device: it runs on the host in the
process that owns the card, beside the expert server.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import Future as ConcurrentFuture
from typing import Any, Awaitable, Callable, Iterable, List, Optional, Sequence, TypeVar, Union

from hivemind_tpu_torch.dht.node import DHTNode
from hivemind_tpu_torch.dht.routing import DHTKey, Subkey
from hivemind_tpu_torch.dht.validation import CompositeValidator, RecordValidatorBase
from hivemind_tpu_torch.p2p import Multiaddr, P2P, PeerID
from hivemind_tpu_torch.utils.logging import get_logger
from hivemind_tpu_torch.utils.loop import EventLoopShutdownError, LoopRunner, get_loop_runner
from hivemind_tpu_torch.utils.timed_storage import DHTExpiration, ValueWithExpiration

logger = get_logger(__name__)

ReturnType = TypeVar("ReturnType")


class DHT:
    """Sync facade over an async DHTNode running on a background event loop.

    :param initial_peers: multiaddrs of existing swarm members (empty = start a swarm)
    :param start: if True, start immediately (else call ``.run_in_background()``)
    """

    def __init__(
        self,
        initial_peers: Sequence[Union[str, Multiaddr]] = (),
        *,
        start: bool = False,
        p2p: Optional[P2P] = None,
        record_validators: Iterable[RecordValidatorBase] = (),
        num_workers: int = 4,
        loop_runner: Optional[LoopRunner] = None,
        **kwargs,
    ):
        self.initial_peers = list(initial_peers)
        self.kwargs = kwargs
        self.num_workers = num_workers
        self._record_validator = CompositeValidator(record_validators)
        self._p2p_arg = p2p
        self._node: Optional[DHTNode] = None
        self._runner = loop_runner if loop_runner is not None else get_loop_runner()
        self.is_alive = False
        if start:
            self.run_in_background(await_ready=True)

    # ------------------------------------------------------------------ lifecycle

    def run_in_background(self, await_ready: bool = True, timeout: Optional[float] = None) -> None:
        future = self._runner.run_coroutine(self._create_node(), return_future=True)
        if await_ready:
            future.result(timeout)

    async def _create_node(self) -> None:
        if self._node is not None:
            return
        # a blocked event loop makes this peer look like a network straggler to
        # the whole swarm: watch for stalls from the moment the node exists
        from hivemind_tpu_torch.telemetry.watchdog import ensure_watchdog

        ensure_watchdog(asyncio.get_event_loop())
        self._node = await DHTNode.create(
            p2p=self._p2p_arg,
            initial_peers=self.initial_peers,
            num_workers=self.num_workers,
            record_validator=self._record_validator,
            **self.kwargs,
        )
        self.is_alive = True

    @property
    def node(self) -> DHTNode:
        assert self._node is not None, "DHT is not started; pass start=True or call run_in_background()"
        return self._node

    def shutdown(self) -> None:
        if self._node is not None:
            node, self._node = self._node, None
            self.is_alive = False
            coro = node.shutdown()
            try:
                self._runner.run_coroutine(coro)
            except EventLoopShutdownError:
                coro.close()  # loop already gone: release the un-awaited coroutine
            except Exception as e:
                logger.warning(f"DHT node shutdown raised: {e!r}")

    def __enter__(self) -> "DHT":
        if self._node is None:
            self.run_in_background(await_ready=True)
        return self

    def __exit__(self, *args) -> None:
        self.shutdown()

    def __del__(self):
        try:
            if self.is_alive:
                self.shutdown()
        except Exception:
            pass

    # ------------------------------------------------------------------ API

    def get(
        self, key: DHTKey, latest: bool = False, return_future: bool = False, **kwargs
    ) -> Union[Optional[ValueWithExpiration], ConcurrentFuture]:
        future = self._runner.run_coroutine(self.node.get(key, latest, **kwargs), return_future=True)
        return future if return_future else future.result()

    def store(
        self,
        key: DHTKey,
        value: Any,
        expiration_time: DHTExpiration,
        subkey: Optional[Subkey] = None,
        return_future: bool = False,
        **kwargs,
    ) -> Union[bool, ConcurrentFuture]:
        future = self._runner.run_coroutine(
            self.node.store(key, value, expiration_time, subkey, **kwargs), return_future=True
        )
        return future if return_future else future.result()

    def run_coroutine(
        self,
        coro: Callable[["DHT", DHTNode], Awaitable[ReturnType]],
        return_future: bool = False,
    ) -> Union[ReturnType, ConcurrentFuture]:
        """Execute ``coro(dht, node)`` on the DHT's event loop."""

        async def _wrap() -> ReturnType:
            return await coro(self, self.node)

        future = self._runner.run_coroutine(_wrap(), return_future=True)
        return future if return_future else future.result()

    async def replicate_p2p(self) -> P2P:
        """The underlying transport, for components that share this peer's identity
        and connections (the expert server and clients). Async, as the JAX package's
        is; in-process there is exactly one P2P to share."""
        return self.node.p2p

    def add_validators(self, record_validators: Iterable[RecordValidatorBase]) -> None:
        """Merge extra validators (they may be added after start)."""
        self._record_validator.extend(record_validators)

    def get_visible_maddrs(self, latest: bool = False) -> List[Multiaddr]:
        return self._runner.run_coroutine(self.node.get_visible_maddrs(latest))

    @property
    def peer_id(self) -> PeerID:
        return self.node.peer_id

    def __repr__(self):
        status = "alive" if self.is_alive else "not started"
        return f"DHT({status}, {len(self.initial_peers)} initial peers)"
