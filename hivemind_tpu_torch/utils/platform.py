"""The ``--device`` flag of the port's command-line entry points and examples (the
counterpart of hivemind_tpu/utils/platform.py's ``--platform``). The port has no
platform plugin to force: it runs on the card (``cuda``) unless asked for the
CPU, and raises when asked for a card it does not have."""

from __future__ import annotations

import argparse

import torch

from hivemind_tpu_torch.utils.device import resolve_device


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the blocks run: the card (default), or the CPU's plain "
                             "PyTorch path when asked")


def apply_device(args: argparse.Namespace) -> torch.device:
    """``args.device`` resolved: raises before anything starts when there is no card."""
    return resolve_device(args.device)
