"""A cell of BENCHMARK.json at a size a CPU test can hold: the canvas
64x128, float32, and the CPU sizes of the configuration's builder (its
`tiny`); the batch and pool small. Only the sizes change: the training
and predict loops, readers and checks are the run's own."""

from __future__ import annotations

import torch

from perfbench.bench import common


def tiny_cell(name: str, root=common.ROOT) -> dict:
    cell = common.load_cell(name, root)
    c = cell["config"]
    c.update(canvas=[64, 128], compute_dtype="float32")
    common.builder(c, root).tiny(c)
    t = cell["traffic"]
    if t["kind"] == "train":
        t.update(batch=2, max_gt=32, warm_cycles=0, profiled_units=1,
                 named_units=1)
    else:
        t.update(pool=3, max_gt=32, profiled_units=3, named_units=2)
    return cell


def run_tiny(name: str, seed: int = 2**31 + 5, traced: bool = False,
             seconds: float = 0.2, root=common.ROOT, cell=None):
    from perfbench import run

    torch.set_num_threads(2)
    cell = cell or tiny_cell(name, root)
    return run.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                        root=root)
