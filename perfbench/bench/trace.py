"""The reading of a torch.profiler trace (its Chrome JSON, events in
microseconds) into what the per-layer metrics need: the device's busy time
as the union of its kernel, memcpy and memset intervals (overlapping
streams counted once), the idle gaps named by the host operation in flight,
the device time by kernel category and by kernel."""

from __future__ import annotations

import bisect
import collections
import json

from . import kernels

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_MARK = "perfbench.profiled"


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals) -> list:
    """Merged, sorted [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(merged, lo: float, hi: float) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in merged
            if e > lo and s < hi]


def _end(e) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


def window_bounds(events) -> tuple:
    """The profiled sub-window, in the trace's microseconds: the host
    annotation WINDOW_MARK where the trace holds host operations, else (a
    trace of the device and the CUDA runtime alone) from the end of the
    first cudaDeviceSynchronize to the end of the last, the synchronises
    that bracket the sub-window."""
    marks = [e for e in events if e.get("name") == WINDOW_MARK
             and e.get("cat") == "user_annotation"]
    if len(marks) == 1:
        return float(marks[0]["ts"]), _end(marks[0])
    syncs = sorted(_end(e) for e in events
                   if e.get("name") == "cudaDeviceSynchronize")
    if len(syncs) < 2:
        raise ValueError(f"the trace holds {len(marks)} window marks and "
                         f"{len(syncs)} device synchronises")
    return syncs[0], syncs[-1]


class Profile:
    """One profiled sub-window: `events` of its trace, bounded as
    `window_bounds` says, holding `units` DG cycles or requests, whose
    kernels the kernel files `kernel_ids` (the cell's,
    common.cell_kernels; None: every file) claim before the generic
    categories."""

    def __init__(self, events, units: int, kernel_ids=None):
        self.lo, self.hi = window_bounds(events)
        self.units = units
        self.kernel_ids = kernel_ids
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and self.lo <= float(e["ts"]) < self.hi]
        self.host = sorted((e for e in events if e.get("cat") in HOST_CATS),
                           key=lambda e: float(e["ts"]))
        self.busy = clip(union((float(e["ts"]), float(e["ts"])
                                + float(e.get("dur", 0)))
                               for e in self.device), self.lo, self.hi)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def gaps(self) -> list:
        """[start, end] of every interval of the window with no device
        operation running."""
        out, t = [], self.lo
        for s, e in self.busy:
            if s > t:
                out.append([t, s])
            t = max(t, e)
        if t < self.hi:
            out.append([t, self.hi])
        return out

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at `t` (the latest-started
        one that still covers it), or 'host: between operations'."""
        starts = self._starts()
        i = bisect.bisect_right(starts, t)
        for e in reversed(self.host[max(0, i - 5000):i]):
            if float(e["ts"]) + float(e.get("dur", 0)) >= t:
                return e["name"]
        return "host: between operations"

    def _starts(self):
        if not hasattr(self, "_start_cache"):
            self._start_cache = [float(e["ts"]) for e in self.host]
        return self._start_cache

    def device_s_by(self, key) -> collections.Counter:
        out = collections.Counter()
        for e in self.device:
            out[key(e["name"])] += float(e.get("dur", 0)) / 1e6
        return out

    def category_s(self) -> collections.Counter:
        return self.device_s_by(
            lambda name: kernels.category(name, self.kernel_ids))

    def kernel_s(self) -> collections.Counter:
        """Device seconds by the id of the port's kernel that claims each
        kernel (None: none of them)."""
        return self.device_s_by(
            lambda name: kernels.kernel_id(name, self.kernel_ids))

    def breakdown(self, named: "Profile", n: int = 10) -> dict:
        """The device operations with the most time in this sub-window and
        the idle time of `named`, a sub-window profiled with the host's
        operations, by the host operation in flight; each the `n` largest,
        in seconds."""
        ops = self.device_s_by(lambda name: name[:200]).most_common(n)
        idle = collections.Counter()
        for s, e in named.gaps():
            idle[named.host_op_at(0.5 * (s + e))[:200]] += (e - s) / 1e6
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle.most_common(n)]}
