"""Device-time measurement: the one home of how the port's scripts time
work (chip_smoke.py, bench_torch.py, scripts/check_convergence_torch.py,
scripts/_parts.py and the scripts built on it).

Every function takes an explicit device. On a CUDA device the times come
from CUDA events or from the host clock around work that ends in a
synchronise; on the CPU (the tests) from `time.perf_counter`. A CUDA
device that is not there raises: a measurement never falls back to the
CPU, so a CPU time is never reported as the card's.
"""

from __future__ import annotations

import subprocess
import time

import torch


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"timing on {dev}: no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"timing on {dev}: only cuda and cpu are timed")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU)."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, device):
    """Host-clock ms of `fn()` from a synchronised start to a synchronised
    end (a step or request time). -> (fn's result, ms)."""
    synchronize(device)
    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, (time.perf_counter() - t) * 1e3


def device_time_ms(fn, device, iters: int = 10, warmup: int = 2,
                   queued: bool = True) -> float:
    """Device ms per call of `fn`, over `iters` calls after `warmup`.

    On the card: CUDA events around the calls. With `queued`, the calls are
    queued behind a device sleep that outlasts the host's time to issue
    them, so a kernel shorter than its wrapper's Python is timed on the
    device (a call that synchronises inside still waits for the host).
    Without it they run as the host issues them, and a call whose host
    cost exceeds its kernel's time is timed at the host's rate. On the
    CPU: the host clock around the calls."""
    dev = _device(device)
    synchronize(dev)
    t = time.perf_counter()
    for _ in range(warmup):
        fn()
    synchronize(dev)
    host_s = (time.perf_counter() - t) / max(warmup, 1)
    if dev.type == "cpu":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:  # cycles at up to 2 GHz: twice the issue time, <= 50 ms
            torch.cuda._sleep(int(2e9 * min(0.05, 2 * iters * host_s)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters


def card(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (the
    first card's line, or the line of `device`'s index); 'cpu' on the
    CPU."""
    dev = _device(device)
    if dev.type == "cpu":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[dev.index or 0]


def describe(device) -> dict:
    """What a result line says of the device it ran on: its type, the
    card's name and power limit (`card`) and torch's name of it."""
    dev = _device(device)
    return {"device": dev.type, "card": card(dev),
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")}
