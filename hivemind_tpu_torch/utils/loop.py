"""The port's process-wide event loop (the port's copy of
hivemind_tpu/utils/loop.py): one asyncio loop on a background thread, onto which
components schedule coroutines; synchronous callers get
``concurrent.futures.Future`` handles. One process owns the card, and forking
after CUDA is initialized is unsafe, so services share this loop instead of
running as forked daemons. It is separate from the JAX package's loop when both
packages are loaded in one process.
"""

from __future__ import annotations

import asyncio
import atexit
import threading
from typing import Any, Coroutine, Optional, TypeVar

from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

T = TypeVar("T")


class EventLoopShutdownError(RuntimeError):
    """Raised when scheduling onto a loop runner that has shut down."""


class LoopRunner:
    """An asyncio event loop running on a dedicated daemon thread.

    ``run_coroutine(coro)`` returns a concurrent Future (sync handle);
    ``run_coroutine(coro, return_future=True)`` returns it without waiting.
    """

    def __init__(self, name: str = "hmtpu-torch-loop"):
        self._name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._closed = False
        self._start_lock = threading.Lock()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        self._ensure_started()
        assert self._loop is not None
        return self._loop

    def _ensure_started(self) -> None:
        if self._started.is_set():
            return
        with self._start_lock:
            if self._started.is_set():
                return
            if self._closed:
                raise EventLoopShutdownError(f"{self._name} is shut down")

            def _run():
                loop = asyncio.new_event_loop()
                asyncio.set_event_loop(loop)
                self._loop = loop
                self._started.set()
                try:
                    loop.run_forever()
                finally:
                    try:
                        pending = asyncio.all_tasks(loop)
                        for task in pending:
                            task.cancel()
                        if pending:
                            loop.run_until_complete(
                                asyncio.gather(*pending, return_exceptions=True)
                            )
                    finally:
                        loop.close()

            self._thread = threading.Thread(target=_run, name=self._name, daemon=True)
            self._thread.start()
            self._started.wait()

    def run_coroutine(
        self, coro: Coroutine[Any, Any, T], return_future: bool = False
    ) -> Any:
        """Schedule a coroutine onto the loop. Returns the result (blocking) or a
        concurrent.futures.Future if return_future=True."""
        self._ensure_started()
        if self._closed:
            raise EventLoopShutdownError(f"{self._name} is shut down")
        future = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return future if return_future else future.result()

    def call_soon(self, callback, *args) -> None:
        self._ensure_started()
        self.loop.call_soon_threadsafe(callback, *args)

    @property
    def is_running(self) -> bool:
        return self._started.is_set() and not self._closed

    def shutdown(self, timeout: float = 5.0) -> None:
        if self._closed or not self._started.is_set():
            self._closed = True
            return
        self._closed = True
        assert self._loop is not None
        self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout)


_global_runner: Optional[LoopRunner] = None
_global_lock = threading.Lock()


def get_loop_runner() -> LoopRunner:
    """The process-wide shared loop runner (created lazily)."""
    global _global_runner
    with _global_lock:
        if _global_runner is None or not _global_runner.is_running:
            _global_runner = LoopRunner()
        return _global_runner


@atexit.register
def _shutdown_at_exit():
    global _global_runner
    if _global_runner is not None:
        _global_runner.shutdown(timeout=1.0)
        _global_runner = None
