"""What every cell shares: finding a cell's files by name (its
configuration's builder and the port's kernel files among them), spans, the
closing checks and the result line."""

from __future__ import annotations

import functools
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# top-level module names that no process of the benchmark may hold: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "dgod_tpu")


class CellError(RuntimeError):
    """The cell cannot run as described (a file missing, a bad entry)."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CellError(f"{path}: not found") from e


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The workload `name` of root/BENCHMARK.json with its configuration,
    traffic mix, limits and per-layer metrics, each read from its own file.
    -> dict(bench, cell, config, traffic, limits, per_layer, end_to_end)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{name}.json")

    def here(metric):
        return name in metric.get("workloads", [name])

    return dict(bench=bench, cell=cell, config=config, traffic=traffic,
                limits=limits, config_entry=entry,
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` function of perfbench/metrics/<name>.py."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"{path}: no reader for the metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@functools.lru_cache(maxsize=None)
def _load(path: Path, module_name: str):
    """The module of the file `path`, executed once per path."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def builder(config: dict, root: Path = ROOT):
    """The module perfbench/builders/<family, lower case>.py of `config`,
    through which the configuration brings its architecture: both sides'
    models, its draws, its model FLOPs, the port's kernels on each path and
    its CPU sizes."""
    family = config["family"].lower()
    path = root / "perfbench" / "builders" / f"{family}.py"
    if not path.exists():
        raise CellError(f"{path}: no builder for the family "
                        f"{config['family']!r}")
    return _load(path, f"perfbench_builder_{family}")


def kernel_files(ids=None, root: Path = ROOT) -> dict:
    """The port's kernels, one file each, perfbench/kernels/<id>.py: id ->
    module with CATEGORY, PATTERN and RANK (the order in which the patterns
    claim a kernel's name, lowest first), launches() and work(sizes, batch,
    max_gt). `ids`: only these files (a cell's, its builder's `kernels_on`),
    so that a cell never loads a kernel file it does not launch; None: every
    file. Ordered by RANK."""
    folder = root / "perfbench" / "kernels"
    if ids is None:
        paths = sorted(folder.glob("*.py"))
    else:
        paths = [folder / f"{kid}.py" for kid in ids]
        for p in paths:
            if not p.exists():
                raise CellError(f"{p}: no file for the kernel {p.stem!r}")
    modules = {p.stem: _load(p, f"perfbench_kernel_{p.stem}") for p in paths}
    return dict(sorted(modules.items(), key=lambda kv: (kv[1].RANK, kv[0])))


def cell_kernels(config: dict, path: str, root: Path = ROOT) -> tuple:
    """The ids of the port's kernels that `path` ('train' or 'predict') of
    `config` may launch, as its builder lists them (`kernels_on`)."""
    return tuple(sorted(builder(config, root).kernels_on(path, config)))


def forbidden_modules(modules=None) -> list:
    """The modules held in `modules` (sys.modules) whose top-level name, the
    part before the first dot, is one of FORBIDDEN_MODULES, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0.01 s steps), so
    that set-up includes the interpreter's start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat(5), after pid and comm
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Spans:
    """Host-clock spans (name, start, end) in seconds of perf_counter, kept
    in memory; `on` False records nothing (the untraced run)."""

    def __init__(self, on: bool):
        self.on = on
        self.items = []

    def span(self, name: str):
        return _Span(self, name)

    def write(self, path: Path) -> None:
        with open(path, "w") as f:
            json.dump(self.items, f)


class _Span:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.spans.on:
            self.spans.items.append((self.name, self.t0,
                                     time.perf_counter()))
        return False


def median(values) -> float:
    return float(statistics.median(values))


def percentile(values, q: float) -> float:
    """The q-th percentile of all `values`, linear between the two nearest
    ranks (numpy's default), over every value and not over chunks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def verdict(numbers: dict, limits: dict) -> tuple:
    """Each number compared beside its limit: -> (correct, {name: {value,
    limit}}). A number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= limit
        checks[name] = {"value": value if finite else None, "limit": limit}
    return ok, checks


def emit(result: dict, checks: dict) -> None:
    """The closing lines: each number beside its limit on stderr, then the
    result as one JSON line on stdout with the checks as its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
