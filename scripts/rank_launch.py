"""Run a function on N ranks of one host without torchrun: the launcher of
the CPU tests (gloo ranks) and of scripts/check_multigpu_torch.py (one
card per rank, NCCL). Users launch training with torchrun.

    results = spawn(fn, world, args, store_dir=DIR, device="cpu")

Each rank is a fresh process (`torch.multiprocessing.start_processes`,
spawned) with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE). It joins the group through a file store in
`store_dir` (no port to pick, so launches in parallel do not collide),
runs `fn(*args)`, saves its result there and leaves the group. The parent
waits at most `timeout` seconds: a rank that raises stops the others (one
rank that fails leaves the rest waiting in a collective), and so does the
deadline.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dgod_tpu_torch.parallel import multihost


def _rank_main(rank, fn, args, world, device, store_dir, timeout):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    multihost.initialize(
        coordinator_address="file://" + os.path.join(store_dir, "store"),
        num_processes=world, process_id=rank, device=device,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(store_dir, f"result{rank}.pt"))


def spawn(fn, world: int, args=(), *, store_dir: str, device=None,
          timeout: float = 120.0):
    """fn(*args) on `world` ranks (a module-level `fn`: it is pickled by
    name); `device` "cpu" for gloo ranks, None for one card per rank.
    -> the ranks' return values, in rank order."""
    os.makedirs(store_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, world, device, store_dir, timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        # raises (and stops the other ranks) as soon as one rank fails
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                late = [r for r, p in enumerate(ctx.processes)
                        if p.is_alive()]
                raise TimeoutError(
                    f"ranks {late} still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    results = []
    for r in range(world):
        path = os.path.join(store_dir, f"result{r}.pt")
        results.append(torch.load(path, weights_only=False))
        os.remove(path)  # results may hold a model's parameters
    return results
