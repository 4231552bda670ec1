"""Timing arithmetic: frozen copies of `host_ms`, `card` and `describe` from
dgod_tpu_torch/utils/timing.py (the host clock around work that ends in a
synchronise; the card's name and power limit), CUDA only: a measurement of
the benchmark never falls back to the CPU."""

from __future__ import annotations

import subprocess
import time

import torch


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, device):
    """Host-clock ms of `fn()` from a synchronised start to a synchronised
    end. -> (fn's result, ms)."""
    synchronize(device)
    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, (time.perf_counter() - t) * 1e3


def card(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    the card of `device`."""
    dev = torch.device(device)
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[dev.index or 0]


def describe(device) -> dict:
    """The result line's `device`: platform, torch's name of the card, the
    cards used, and nvidia-smi's name and power limit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "card": card(dev)}
