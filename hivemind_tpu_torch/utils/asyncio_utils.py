"""Asyncio helpers (the port's copy of hivemind_tpu/utils/asyncio_utils.py without
``switch_to_uvloop``: ``spawn`` with its background-task error counter,
``run_in_executor``, ``enter_asynchronously``, the async-iterator helpers the
averager streams parts through, and the cancellation helpers)."""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from contextlib import asynccontextmanager
from typing import AsyncIterable, AsyncIterator, Awaitable, Callable, Optional, Tuple, TypeVar, Union

from hivemind_tpu_torch.utils.logging import get_logger

T = TypeVar("T")

_SENTINEL = object()


async def anext_safe(aiter: AsyncIterator[T]) -> Union[T, object]:
    """Like anext() but returns a sentinel instead of raising StopAsyncIteration."""
    try:
        return await aiter.__anext__()
    except StopAsyncIteration:
        return _SENTINEL


async def aiter_with_timeout(iterable: AsyncIterable[T], timeout: Optional[float]) -> AsyncIterator[T]:
    """Iterate over an async iterable, raising asyncio.TimeoutError if any single item
    takes longer than ``timeout`` seconds."""
    iterator = iterable.__aiter__()
    while True:
        item = await asyncio.wait_for(anext_safe(iterator), timeout=timeout)
        if item is _SENTINEL:
            return
        yield item


async def as_aiter(*items: T) -> AsyncIterator[T]:
    for item in items:
        yield item


async def azip(*iterables: AsyncIterable) -> AsyncIterator[Tuple]:
    iterators = [it.__aiter__() for it in iterables]
    while True:
        results = await asyncio.gather(*(anext_safe(it) for it in iterators))
        if any(r is _SENTINEL for r in results):
            return
        yield tuple(results)


async def achain(*iterables: AsyncIterable[T]) -> AsyncIterator[T]:
    for it in iterables:
        async for item in it:
            yield item


async def aenumerate(iterable: AsyncIterable[T], start: int = 0) -> AsyncIterator[Tuple[int, T]]:
    index = start
    async for item in iterable:
        yield index, item
        index += 1


async def amap_in_executor(
    fn: Callable[..., T],
    *iterables: AsyncIterable,
    max_prefetch: int = 1,
    executor: Optional[ThreadPoolExecutor] = None,
) -> AsyncIterator[T]:
    """Apply a blocking fn to items of async iterable(s) in a thread executor with
    at most ``max_prefetch`` results computed ahead of the consumer: the averager
    overlaps part compression with the network this way."""
    assert max_prefetch > 0
    loop = asyncio.get_event_loop()
    queue: asyncio.Queue = asyncio.Queue(max_prefetch)

    async def _producer():
        try:
            async for args in azip(*iterables):
                await queue.put(loop.run_in_executor(executor, fn, *args))
            await queue.put(None)
        except asyncio.CancelledError:
            # the consumer is gone; never block on a full queue in cleanup
            try:
                queue.put_nowait(None)
            except asyncio.QueueFull:
                pass
            raise

    producer = asyncio.create_task(_producer())
    try:
        while True:
            future = await queue.get()
            if future is None:
                break
            yield await future
        await producer
    finally:
        if not producer.done():
            producer.cancel()


async def attach_event_on_finished(iterable: AsyncIterable[T], event: asyncio.Event) -> AsyncIterator[T]:
    """Yield from iterable; set the event when iteration ends for any reason."""
    try:
        async for item in iterable:
            yield item
    finally:
        event.set()


async def cancel_and_wait(task: asyncio.Task) -> bool:
    """Cancel a task and wait until the cancellation lands. True if it was cancelled
    (rather than finishing or failing first)."""
    task.cancel()
    try:
        await task
        return False
    except asyncio.CancelledError:
        return True
    except BaseException:
        return False


async def await_cancelled(awaitable: Awaitable) -> bool:
    try:
        await awaitable
        return False
    except asyncio.CancelledError:
        return True
    except BaseException:
        return False


# strong refs: asyncio keeps only a weak reference to running tasks, so a spawned
# task with no other referent is garbage-collectable MID-FLIGHT
_background_tasks: set = set()
_background_error_counter = None


def _count_background_error(site: str) -> None:
    global _background_error_counter
    if _background_error_counter is None:
        # lazy: the telemetry package pulls in its exporter and monitor, which must
        # not become an import-time dependency of the utils layer
        from hivemind_tpu_torch.telemetry.registry import REGISTRY

        _background_error_counter = REGISTRY.counter(
            "hivemind_background_task_errors_total",
            "exceptions raised by fire-and-forget background tasks, by spawn site",
            ("site",),
        )
    _background_error_counter.inc(site=site)


def _on_background_done(name: str, task: asyncio.Task) -> None:
    _background_tasks.discard(task)
    if task.cancelled():
        return
    exc = task.exception()  # marks the exception retrieved either way
    if exc is None:
        return
    get_logger(__name__).warning(f"background task {name!r} failed: {exc!r}")
    try:
        _count_background_error(name)
    except Exception:  # counting must never mask the original failure
        pass


def spawn(coro: Awaitable, *, name: str) -> asyncio.Task:
    """Tracked fire-and-forget: keeps a strong reference until the task finishes,
    names the task, and on failure logs and increments
    ``hivemind_background_task_errors_total{site}`` instead of letting the
    exception rot until interpreter shutdown. The returned task may still be awaited or
    cancelled by the caller."""
    task = asyncio.ensure_future(coro)
    task.set_name(name)
    _background_tasks.add(task)
    task.add_done_callback(lambda t, _name=name: _on_background_done(_name, t))
    return task


# threads start lazily, at the first submit — importing this module starts none
_blocking_executor = ThreadPoolExecutor(max_workers=32, thread_name_prefix="hmtpu-torch-blocking")


async def run_in_executor(fn: Callable[..., T], *args) -> T:
    """Run a blocking function in the shared background thread pool."""
    return await asyncio.get_event_loop().run_in_executor(_blocking_executor, fn, *args)


# lock acquisition can block indefinitely, so it must never share a bounded pool with
# productive work; the watchdog reports this pool's backlog as ``lock``
_lock_executor = ThreadPoolExecutor(max_workers=2**16, thread_name_prefix="hmtpu-torch-lock")


@asynccontextmanager
async def enter_asynchronously(lock):
    """Acquire a synchronous threading.Lock without blocking the event loop."""
    await asyncio.get_event_loop().run_in_executor(_lock_executor, lock.acquire)
    try:
        yield lock
    finally:
        lock.release()
