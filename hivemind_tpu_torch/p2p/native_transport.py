"""Zero-config native transport (the port's copy of
hivemind_tpu/p2p/native_transport.py): spawn a PRIVATE relay daemon for this process
and route the data-plane proxy through it, both directions.

The native tier is optional (the asyncio transport is complete), but
``P2P.create(native_transport=True)`` puts the whole data plane in a daemon with one
flag: a child is spawned (its binary built from ``native/hm_relayd.cpp`` by
``ops/_build_relayd.py`` when needed), listening for its control frames ONLY on a
0600 AF_UNIX socket (the key-handoff trust boundary; its TCP listener binds
127.0.0.1), and the P2P routes outbound dials ('X') and its public listener ('Y')
through it, so ChaCha20-Poly1305 for both directions runs in C++ outside the Python
event loop.

The daemon's lifetime is tied to the P2P: ``shutdown()`` kills it, and it dies with
its parent. If it dies first, the inbound watchdog falls back to direct listening
(``P2P._watch_inbound_proxy``) while outbound dials degrade to plain sockets.
Without a C++ toolchain the spawn warns and returns None, and the P2P stays on the
asyncio data plane, as the JAX package does."""

from __future__ import annotations

import ctypes
import functools
import os
import select
import shutil
import signal
import subprocess
import tempfile
import time
from typing import Optional, Tuple

from hivemind_tpu_torch.ops._build_relayd import build_relayd
from hivemind_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class NativeTransportDaemon:
    """A private relay daemon child serving the data-plane proxy over a 0600 unix
    socket. Use :func:`spawn_native_transport`."""

    def __init__(self, process: subprocess.Popen, unix_path: str, port: int, workdir: str, owns_workdir: bool):
        self.process = process
        self.unix_path = unix_path
        self.port = port  # the daemon's TCP listener (relay and 'Y' control ride it too)
        self._workdir = workdir
        self._owns_workdir = owns_workdir

    @property
    def alive(self) -> bool:
        return self.process.poll() is None

    def shutdown(self) -> None:
        if self.process.poll() is None:
            self.process.kill()
        self.process.wait()
        if self.process.stdout is not None:
            self.process.stdout.close()
        try:
            os.unlink(self.unix_path)
        except OSError:
            pass
        if self._owns_workdir:
            shutil.rmtree(self._workdir, ignore_errors=True)


def die_with_parent():
    """A pre-exec hook that makes the child get SIGKILL when its parent dies (Linux
    PR_SET_PDEATHSIG), so a killed trainer cannot orphan a daemon with open listeners
    (the graceful path reaps it through ``shutdown()``); None where libc has no prctl.
    libc is resolved here, in the parent: the hook runs in the forked child, where
    loading a library could wait forever on a lock another thread held at the fork."""
    try:
        prctl = ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None
    return functools.partial(prctl, 1, signal.SIGKILL)  # 1 = PR_SET_PDEATHSIG


def read_daemon_banner(process: subprocess.Popen, timeout: float) -> Optional[Tuple[str, str]]:
    """Bounded read of the daemon's two startup lines (it prints exactly two, in one
    flush). Returns ``(line1, line2)``, or None on timeout or early exit, so a binary
    that prints something else trips the bound instead of hanging the caller.

    Reads the raw fd, not a buffered wrapper: after a buffered readline the second
    line would sit in the Python-side buffer, where select() on the fd cannot see it."""
    fd = process.stdout.fileno()
    buf = b""
    deadline = time.monotonic() + timeout
    while buf.count(b"\n") < 2:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        ready, _, _ = select.select([fd], [], [], remaining)
        if not ready:
            return None
        chunk = os.read(fd, 4096)
        if not chunk:  # EOF: the child died before finishing its banner
            return None
        buf += chunk
    lines = buf.decode(errors="replace").splitlines()
    return lines[0].strip(), lines[1].strip()


def banner_port(line: str) -> int:
    """The TCP port of the banner's first line, ``relay listening on port <n>``."""
    return int(line.rsplit(" ", 1)[-1])


def _listener_binds_any(port: int) -> Optional[bool]:
    """True if a LISTEN socket on ``port`` is bound to 0.0.0.0 (read from
    /proc/net/tcp); None when that table is unavailable or the port is absent."""
    try:
        with open("/proc/net/tcp") as table:
            next(table)  # header
            for line in table:
                fields = line.split()
                if len(fields) < 4 or fields[3] != "0A":  # 0A = TCP_LISTEN
                    continue
                addr_hex, _, port_hex = fields[1].partition(":")
                if int(port_hex, 16) == port:
                    return addr_hex == "00000000"
    except (OSError, ValueError, StopIteration):
        return None
    return None


def spawn_native_transport(workdir: Optional[str] = None, banner_timeout: float = 30.0
                           ) -> Optional[NativeTransportDaemon]:
    """Build (if needed) and spawn the relay daemon with a fresh unix socket.
    Returns None, with a warning, when the toolchain or the binary is unavailable, so
    callers can stay on the asyncio transport.

    Blocking (a build takes seconds): async callers run it in an executor, as
    ``P2P.create`` does."""
    binary, error = build_relayd()
    if binary is None:
        logger.warning(f"{error}; staying on the asyncio data plane")
        return None

    owns_workdir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="hivemind_native_")
    unix_path = os.path.join(workdir, "data_plane.sock")
    # 127.0.0.1: a private daemon's control surface is the 0600 unix socket, and its TCP
    # listener (relay and 'Y' control) must not be reachable from off-host. Public relays
    # are started explicitly (hivemind_cli/run_relay.py), without this argument.
    process = subprocess.Popen(
        [str(binary), "0", "", unix_path, "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        preexec_fn=die_with_parent(),
    )

    def give_up(reason: str) -> None:
        process.kill()
        process.wait()
        process.stdout.close()
        if owns_workdir:
            shutil.rmtree(workdir, ignore_errors=True)
        logger.warning(f"{reason}; staying on the asyncio data plane")

    banner = read_daemon_banner(process, banner_timeout)
    if banner is None:
        give_up(f"the daemon printed no complete banner within {banner_timeout:.0f} s")
        return None
    try:
        port = banner_port(banner[0])
    except ValueError:
        give_up(f"unexpected daemon banner {banner[0]!r}")
        return None
    if not os.path.exists(unix_path):
        give_up("the daemon did not create its unix socket")
        return None
    if _listener_binds_any(port):
        logger.warning("the private relay daemon bound its TCP listener to 0.0.0.0, not 127.0.0.1: "
                       f"{binary} does not take the bind-host argument")
    logger.debug(f"private data-plane daemon up (pid {process.pid}, socket {unix_path})")
    return NativeTransportDaemon(process, unix_path, port, workdir, owns_workdir)
