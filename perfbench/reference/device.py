"""Device selection for the port's entry points.

Entry points take `device=None`, which means the card: a host without CUDA
raises rather than running on the CPU. The CPU is used only when the caller
asks for it (`device="cpu"`), as the tests do. In a process that a launcher
started as one of several (torchrun sets `LOCAL_RANK`), the card is this
process's own, `cuda:LOCAL_RANK`, and it is made the current device.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    local = os.environ.get("LOCAL_RANK")
    if device is None:
        dev = torch.device("cuda" if local is None else f"cuda:{int(local)}")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dgod_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if device is None and local is not None:
        torch.cuda.set_device(dev)
    return dev
