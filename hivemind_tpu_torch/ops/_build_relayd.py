"""Build the port's relay daemon (``native/hm_relayd.cpp``), a host program.

The counterpart of ``_build.py`` for the one native source that is not a kernel:
``g++`` (or ``$CXX``) compiles it with ``-O2 -std=c++17 -ldl`` straight into
``build/hivemind_tpu_torch/hm_relayd-<digest>``, named by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one reused. No ``make``
is run. A file lock serializes builds across processes (test workers, forked
children), so the binary is built once; the compiler writes a temporary file
that replaces the target atomically.

No path that this helper writes or runs contains ``relay_daemon``: process lists
are searched for that name, and the daemon must not be taken for another.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

from hivemind_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "hm_relayd.cpp"
CXX_FLAGS = ("-O2", "-std=c++17")
LINK_FLAGS = ("-ldl",)


def relayd_path() -> Path:
    digest = hashlib.sha256(" ".join((*CXX_FLAGS, *LINK_FLAGS)).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"hm_relayd-{digest.hexdigest()[:16]}"


def build_relayd() -> Tuple[Optional[Path], str]:
    """``(binary, "")`` once the daemon is built (a no-op when it is fresh), or
    ``(None, reason)`` when it cannot be: no compiler, or a failed compile. The
    caller decides whether that degrades or raises."""
    target = relayd_path()
    if target.exists():
        return target, ""
    compiler = os.environ.get("CXX", "g++")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "hm_relayd.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if target.exists():  # another process built it while this one waited
                return target, ""
            fd, tmp = tempfile.mkstemp(prefix=f".{target.name}.", dir=BUILD_DIR)
            os.close(fd)
            try:
                build = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, str(SOURCE), *LINK_FLAGS],
                                       capture_output=True, text=True)
                if build.returncode != 0:
                    return None, f"{compiler} failed to build {SOURCE.name} (exit {build.returncode}):\n{build.stderr[-500:]}"
                os.chmod(tmp, 0o755)
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except OSError as e:  # no compiler, an unwritable build directory
        return None, f"native toolchain unavailable: {e!r}"
    return target, ""
