"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a request
for CUDA on a host without it raises instead of moving to the CPU on its own.
A CUDA device is always indexed: a bare ``cuda`` becomes the current device
(``cuda:0`` unless the caller switched), so that tables cached by device
(ops/colors.py, models/render.py) never see one card under two names.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
