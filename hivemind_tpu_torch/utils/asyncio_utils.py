"""Asyncio helpers (the port's copy of ``spawn`` and ``run_in_executor`` from
hivemind_tpu/utils/asyncio_utils.py; the JAX package's background-error counter
belongs to the telemetry slice, so a failed background task is logged only)."""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Awaitable, Callable, TypeVar

from hivemind_tpu_torch.utils.logging import get_logger

T = TypeVar("T")

# strong refs: asyncio keeps only a weak reference to running tasks, so a spawned
# task with no other referent is garbage-collectable MID-FLIGHT
_background_tasks: set = set()


def _on_background_done(name: str, task: asyncio.Task) -> None:
    _background_tasks.discard(task)
    if task.cancelled():
        return
    exc = task.exception()  # marks the exception retrieved either way
    if exc is not None:
        get_logger(__name__).warning(f"background task {name!r} failed: {exc!r}")


def spawn(coro: Awaitable, *, name: str) -> asyncio.Task:
    """Tracked fire-and-forget: keeps a strong reference until the task finishes,
    names the task, and logs its failure instead of letting the exception rot
    until interpreter shutdown. The returned task may still be awaited or
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
