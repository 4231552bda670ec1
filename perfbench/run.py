#!/usr/bin/env python3
"""The benchmark of dgod_tpu_torch on one NVIDIA H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Runs one cell of BENCHMARK.json, found by its name together with its
configuration (perfbench/configs), traffic mix (perfbench/traffic), limits
(perfbench/limits) and per-layer metrics (perfbench/metrics), and prints
one JSON line as its last line of output: `correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and last the
numbers of the check beside their limits (`checks`), which also close
standard error.

--trace 0 measures the cell's end-to-end metrics with no tracing on;
--trace 1 repeats the window with the benchmark's spans on, then records
a short steady sub-window with torch.profiler, and reports the per-layer
metrics. Set-up (`setup_s`) runs from the process's start to the window's.

Exits 1 without a result where no CUDA device is available or fewer than
the cell asks for, 2 where the cell cannot be found or read, 3 where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kind_module(traffic: dict):
    from perfbench.bench import predict, train

    kinds = {"train": train, "predict": predict}
    return kinds[traffic["kind"]]


def profile_units(kind, s, units: int, device, cpu_ops: bool,
                  kernel_ids: tuple):
    """Record `units` DG cycles or requests under torch.profiler, from a
    synchronised start to a synchronised end. `cpu_ops`: the host's
    operations too (they cost the host some microseconds each, which
    stretches the window), else the device and the CUDA runtime alone.
    `kernel_ids`: the port's kernels of the cell (common.cell_kernels).
    -> (trace.Profile, the launches of those kernels in the sub-window)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.bench import trace
    from perfbench.bench.common import Spans
    from perfbench.bench.timing import synchronize

    activities = []
    if cpu_ops or device.type != "cuda":
        activities.append(ProfilerActivity.CPU)
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = launch_counts(kernel_ids)
    with profile(activities=activities) as prof:
        synchronize(device)
        with record_function(trace.WINDOW_MARK):
            kind.profiled_units(s, units, Spans(False))
            synchronize(device)
    after = launch_counts(kernel_ids)
    path = Path(tempfile.gettempdir()) / f"perfbench_trace.{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = trace.load(path)
    finally:
        path.unlink()
    return (trace.Profile(events, units, kernel_ids),
            {k: after[k] - before[k] for k in after})


def launch_counts(kernel_ids: tuple) -> dict:
    """The port's own counters of the launches of the kernels
    `kernel_ids`, read through their files (common.kernel_files)."""
    from perfbench.bench import common

    return {kid: k.launches()
            for kid, k in common.kernel_files(kernel_ids).items()}


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             root: Path = ROOT, age=None):
    """One run of `cell` (common.load_cell) on `device`. -> (result line
    without its checks, checks, spans). `age()`: seconds since the
    process started (set-up's clock)."""
    import torch

    from perfbench.bench import common, kernels
    from perfbench.bench.common import Spans
    from perfbench.bench.timing import describe

    kind = kind_module(cell["traffic"])
    age = age or (lambda: 0.0)
    spans = Spans(traced)
    s = kind.setup(cell, seed, device, spans)
    setup_s = age()
    w = kind.window(s, seconds, spans)
    result = {"correct": False, "attempted": w["attempted"],
              "failed": w["failed"]}
    metrics = {}
    device_info = describe(device)
    if not traced:
        values = dict(kind.end_to_end(w), setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ids = common.cell_kernels(cell["config"], kind.PATH, root)
        prof, launches = profile_units(kind, s, cell["traffic"][
            "profiled_units"], device, cpu_ops=False, kernel_ids=ids)
        named, _ = profile_units(kind, s, cell["traffic"]["named_units"],
                                 device, cpu_ops=True, kernel_ids=ids)
        ctx = Context(cell=cell, s=s, window=w, spans=spans, profile=prof,
                      launches=launches, path=kind.PATH, kernels=kernels)
        for m in cell["per_layer"]:
            value = common.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = prof.breakdown(named)
        out = Path(tempfile.gettempdir()) / "perfbench_spans.json"
        spans.write(out)
    if device.type == "cuda":
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    kind.release(s)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = kind.check(s)
    correct, checks = common.verdict(numbers, cell["limits"])
    result["correct"] = correct and w["failed"] == 0
    result["metrics"] = metrics
    result["device"] = device_info
    return result, checks, spans


class Context:
    """What a per-layer metric's reader reads: the cell (`cell`, with its
    `config` and `traffic`), the set-up and window (`s`, `window`), the
    spans, the profiled sub-window (`profile`, a trace.Profile, and the
    launches of the cell's kernels in it), the driver's `path` ('train' or
    'predict'), and the yardstick's `kernels`; the configuration's FLOP
    count is its builder's (readers.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.config = kw["cell"]["config"]
        self.traffic = kw["cell"]["traffic"]


def main(argv=None) -> int:
    from perfbench.bench.common import process_age_s

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.bench import common

    try:
        cell = common.load_cell(args.workload)
    except (common.CellError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks, _ = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), device, age=process_age_s)
    held = common.forbidden_modules()
    if held:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{held}", file=sys.stderr)
        return 3
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
