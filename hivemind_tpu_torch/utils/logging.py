"""Structured logging for hivemind_tpu_torch (a copy of hivemind_tpu/utils/logging.py's
``get_logger``; the port keeps its own copy instead of importing the JAX package).

Env vars: ``HIVEMIND_TPU_LOGLEVEL`` sets the default level, ``HIVEMIND_TPU_COLORS``
forces colors on/off — the same switches as the JAX package.
"""

import logging
import os
import sys
import threading

_ROOT = "hivemind_tpu_torch"
_LOCK = threading.Lock()
_INITIALIZED = False

_RESET = "\033[0m"
_COLORS = {
    logging.DEBUG: "\033[36m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}


def _use_colors() -> bool:
    env = os.getenv("HIVEMIND_TPU_COLORS")
    if env is not None:
        return env.lower() in ("1", "true", "yes", "always")
    return sys.stderr.isatty()


class _Formatter(logging.Formatter):
    def __init__(self, colors: bool):
        super().__init__(fmt="%(asctime)s.%(msecs)03d [%(levelname)s] [%(name)s:%(lineno)d] %(message)s",
                         datefmt="%b %d %H:%M:%S")
        self._colors = colors

    def format(self, record: logging.LogRecord) -> str:
        text = super().format(record)
        if self._colors:
            color = _COLORS.get(record.levelno, "")
            if color:
                return f"{color}{text}{_RESET}"
        return text


def _initialize() -> None:
    global _INITIALIZED
    with _LOCK:
        if _INITIALIZED:
            return
        root = logging.getLogger(_ROOT)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_Formatter(_use_colors()))
        root.addHandler(handler)
        root.propagate = False
        level = os.getenv("HIVEMIND_TPU_LOGLEVEL", "INFO").upper()
        root.setLevel(getattr(logging, level, logging.INFO))
        _INITIALIZED = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    _initialize()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
