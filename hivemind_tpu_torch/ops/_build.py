"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, then loaded with ``ctypes``. Nothing is
built at import: a library is compiled at the first launch of one of its kernels
(or by :func:`build_all`, which starts every ``nvcc`` at once). A source in
``PARTS`` is compiled as that many translation units side by side, each with
``-DHM_PART=<i>`` (which keeps the entry points ``csrc/common.cuh``'s
``HM_IN_PART(i)`` assigns to it), and its objects are then linked into the one
library: its kernels compile in parallel.

Libraries land in ``build/hivemind_tpu_torch/`` beside the package, named by a
hash of the sources and flags, so an edited kernel is rebuilt and an unchanged
one is reused. ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin``
(default ``/usr/local/cuda``, as ``torch.utils.cpp_extension`` assumes).

Each build is the port's compile event: it is recorded on the device telemetry's
compile tracker under the site ``build.<source>`` with its wall seconds. A
library loaded from the build cache is not a compile.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

from hivemind_tpu_torch.telemetry.device import COMPILE_TRACKER

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hivemind_tpu_torch"
SOURCES = ("blockwise_int8", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of every kernel, kept in the build log
)
# the translation units of a source whose kernels take long to compile (the flash passes' wgmma
# instantiations), each built by its own nvcc
PARTS = {"flash_attention": 3, "flash_attention_bwd": 4}

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA toolkit is needed "
        "to build hivemind_tpu_torch's kernels"
    )


def library_path(name: str) -> Path:
    if name not in SOURCES:
        raise KeyError(f"unknown kernel library {name!r}; known: {SOURCES}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


class _Build:
    """The running ``nvcc`` of one library: one for a whole source, or one for each part
    (``PARTS``) and then one that links them. It writes a temporary file that replaces
    ``target`` atomically on success, so a concurrent loader never sees a half-written
    library."""

    def __init__(self, name: str, target: Path):
        self.name, self.target = name, target
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(prefix=f".{target.name}.", dir=target.parent)
        os.close(fd)
        source, parts = str(CSRC / f"{name}.cu"), PARTS.get(name, 1)
        if parts == 1:
            self.objects, commands = [], [[find_nvcc(), *NVCC_FLAGS, "-shared", "-o", self.tmp, source]]
        else:
            self.objects = [f"{self.tmp}.part{i}.o" for i in range(parts)]
            commands = [[find_nvcc(), *NVCC_FLAGS, f"-DHM_PART={i}", "-c", "-o", obj, source]
                        for i, obj in enumerate(self.objects)]
        self.started = time.perf_counter()
        self.procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                      for cmd in commands]

    def finish(self) -> None:
        logs = [proc.communicate()[0] for proc in self.procs]
        failed = next((proc.returncode for proc in self.procs if proc.returncode != 0), 0)
        if not failed and self.objects:
            link = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", self.tmp, *self.objects],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(link.stdout)
            failed = link.returncode
        for obj in self.objects:
            if os.path.exists(obj):
                os.unlink(obj)
        log = "".join(logs)
        self.target.with_suffix(".log").write_text(log)
        if failed:
            os.unlink(self.tmp)
            raise RuntimeError(f"nvcc failed to build {self.name} (exit {failed}):\n{log}")
        os.replace(self.tmp, self.target)
        COMPILE_TRACKER.record_compile(f"build.{self.name}", duration_s=time.perf_counter() - self.started,
                                       signature=self.target.name)


def build_all() -> Dict[str, Path]:
    """Build every missing library, one ``nvcc`` per source, all started together."""
    with _lock:
        targets = {name: library_path(name) for name in SOURCES}
        running = [_Build(name, path) for name, path in targets.items() if not path.exists()]
        errors = []
        for build in running:
            try:
                build.finish()
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return targets


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas resource usage)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _lock:
        library = _libraries.get(name)
        if library is not None:
            return library
        path = library_path(name)
        if not path.exists():
            _Build(name, path).finish()
        library = _libraries[name] = ctypes.CDLL(str(path))
        library.hm_cuda_error_string.argtypes = [ctypes.c_int]
        library.hm_cuda_error_string.restype = ctypes.c_char_p
        return library


def check_launch(library: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a kernel's C entry point reported a CUDA error."""
    if status != 0:
        message = library.hm_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
