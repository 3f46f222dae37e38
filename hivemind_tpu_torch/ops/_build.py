"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, then loaded with ``ctypes``. Nothing is
built at import: a library is compiled at the first launch of one of its kernels
(or by :func:`build_all`, which starts one ``nvcc`` per source, all at once).

Libraries land in ``build/hivemind_tpu_torch/`` beside the package, named by a
hash of the sources and flags, so an edited kernel is rebuilt and an unchanged
one is reused. ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin``
(default ``/usr/local/cuda``, as ``torch.utils.cpp_extension`` assumes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hivemind_tpu_torch"
SOURCES = ("blockwise_int8", "flash_attention", "flash_attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of every kernel, kept in the build log
)

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
    """One running ``nvcc``: it writes a temporary file that replaces ``target``
    atomically on success, so a concurrent loader never sees a half-written library."""

    def __init__(self, name: str, target: Path):
        self.name, self.target = name, target
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, self.tmp = tempfile.mkstemp(prefix=f".{target.name}.", dir=target.parent)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", self.tmp, str(CSRC / f"{name}.cu")]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        log, _ = self.proc.communicate()
        self.target.with_suffix(".log").write_text(log)
        if self.proc.returncode != 0:
            os.unlink(self.tmp)
            raise RuntimeError(f"nvcc failed to build {self.name} (exit {self.proc.returncode}):\n{log}")
        os.replace(self.tmp, self.target)


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
