"""Shared pieces of the port's relay, NAT, auto-relay and native-transport tests: the
port's relay daemon (``hivemind_tpu_torch/native/hm_relayd.cpp``, built by
``ops/_build_relayd.py``) started and reaped inside each test, a check that no
daemon child outlives a test, and the echo handlers of ``test.proto``."""

from __future__ import annotations

import asyncio
import contextlib
import functools
import os
import subprocess
from pathlib import Path
from typing import Iterator, List, NamedTuple

import pytest

from hivemind_tpu_torch.ops._build_relayd import build_relayd
from hivemind_tpu_torch.p2p.native_transport import banner_port, read_daemon_banner
from hivemind_tpu_torch.proto import test_pb2

DAEMON_NAME = "hm_relayd"


def relayd_binary() -> Path:
    """The port's daemon, built if needed; a failed build fails the test (g++ is here)."""
    binary, error = build_relayd()
    assert binary is not None, error
    return binary


class Daemon(NamedTuple):
    process: subprocess.Popen
    port: int
    pubkey_hex: str  # "" when the daemon announced no identity


def start_daemon(*args: str) -> Daemon:
    process = subprocess.Popen([str(relayd_binary()), *(args or ("0",))], stdout=subprocess.PIPE)
    banner = read_daemon_banner(process, timeout=10.0)
    if banner is None:
        stop_daemon(process)
        raise AssertionError("the relay daemon printed no banner")
    identity = banner[1].rsplit(" ", 1)[-1] if banner[1].startswith("relay identity ") else ""
    return Daemon(process, banner_port(banner[0]), identity)


def stop_daemon(process: subprocess.Popen) -> None:
    if process.poll() is None:
        process.kill()
    process.wait()
    process.stdout.close()


@contextlib.contextmanager
def running_daemon(*args: str) -> Iterator[Daemon]:
    daemon = start_daemon(*args)
    try:
        yield daemon
    finally:
        stop_daemon(daemon.process)


@pytest.fixture
def relay_daemon() -> Iterator[Daemon]:
    """A relay daemon of this test alone, reaped at its end."""
    with running_daemon() as daemon:
        yield daemon


def daemon_children() -> List[int]:
    """Pids of this process's children that run the port's daemon, zombies included
    (a daemon killed but never waited for is not reaped)."""
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        comm, _, rest = stat[stat.index("(") + 1:].rpartition(")")
        if int(rest.split()[1]) == os.getpid() and comm.startswith(DAEMON_NAME):
            found.append(int(entry.name))
    return found


@pytest.fixture(autouse=True)
def no_daemon_left() -> Iterator[None]:
    """Every test that starts a daemon reaps it before it ends."""
    yield
    left = daemon_children()
    for pid in left:  # the failure is reported; the next test still starts clean
        with contextlib.suppress(OSError):
            os.kill(pid, 9)
            os.waitpid(pid, 0)
    assert not left, f"relay daemon children left running or unreaped: {left}"


async def add_echo(p2p, name: str, fn) -> None:
    """A unary ``test.proto`` handler ``name`` answering ``fn(number)``."""

    async def handler(request, context):
        return test_pb2.TestResponse(number=fn(request.number))

    await p2p.add_protobuf_handler(name, handler, test_pb2.TestRequest)


async def call_echo(p2p, peer_id, name: str, number: int) -> int:
    response = await p2p.call_protobuf_handler(peer_id, name, test_pb2.TestRequest(number=number),
                                               test_pb2.TestResponse)
    return response.number


def bounded(seconds: float):
    """Run an async test body under ``asyncio.wait_for(..., seconds)``."""

    def wrap(fn):
        @functools.wraps(fn)
        async def run(**kwargs):
            await asyncio.wait_for(fn(**kwargs), seconds)

        return run

    return wrap
