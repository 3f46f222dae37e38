"""Device selection: every entry point of the port runs on ``cuda`` unless the caller
asks for the CPU, and raises (never falls back) when there is no card."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for but absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hivemind_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: expected 'cuda' or 'cpu'")
    return device
