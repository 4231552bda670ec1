"""The program's own spans: the `dgod.*` ranges that
dgod_tpu_torch/utils/logging.py::span opens while a torch.profiler records,
read for the launches, host syncs and device-idle time of each layer.

`of(ctx)`, on its first call for a run.Context, records one more profiled
pass, after the run's own: `traffic["named_units"]` DG cycles or requests
under torch.profiler with the host's operations and the card's activity,
from a synchronised start to a synchronised end, as run.profile_units
records its passes. The reading is kept on the context for the other
readers. A program without the spans reads None.

Attribution:
- the main thread is the one that holds the `dgod.pair` or `dgod.predict`
  spans; only its spans count;
- a launch or a sync counts for a span where its CUDA runtime event, on any
  thread, starts inside one of that span's intervals (backward's launches
  come from autograd's device thread, inside the main thread's
  `dgod.backward`);
- a span's idle time is the overlap of its intervals with the pass's
  device-idle intervals (trace.Profile.gaps: no kernel, memcpy or memset
  running).
"""

from __future__ import annotations

import bisect
import os
import tempfile
from pathlib import Path

from . import trace

PREFIX = "dgod."
ROOTS = ("dgod.pair", "dgod.predict")
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx",
                      "cudaGraphLaunch"})
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


class SpanReading:
    """The spans of one profiled pass (Chrome trace `events`, in
    microseconds) holding `units` DG cycles or requests."""

    def __init__(self, events, units: int):
        self.units = units
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        roots = [e for e in spans if e["name"] in ROOTS]
        main = roots[0]["tid"] if roots else None
        by_name = {}
        for e in spans:
            if e["tid"] == main:
                ts = float(e["ts"])
                by_name.setdefault(e["name"], []).append(
                    (ts, ts + float(e.get("dur", 0))))
        self.intervals = {n: trace.union(v) for n, v in by_name.items()}
        runtime = [e for e in events if e.get("cat") in RUNTIME_CATS]
        self.launches_at = sorted(float(e["ts"]) for e in runtime
                                  if e["name"] in LAUNCHES)
        self.syncs_at = sorted(float(e["ts"]) for e in runtime
                               if e["name"] in SYNCS)
        profile = trace.Profile(events, units)
        self.has_device = bool(profile.device)
        self.gaps = profile.gaps()

    def _count(self, name: str, stamps: list):
        if name not in self.intervals:
            return None
        n = sum(bisect.bisect_left(stamps, e) - bisect.bisect_left(stamps, s)
                for s, e in self.intervals[name])
        return n / self.units

    def launches(self, name: str):
        """Kernel launches per unit inside the span `name`; None where the
        trace has no such span."""
        return self._count(name, self.launches_at)

    def syncs(self, name: str):
        """Host syncs per unit inside the span `name`."""
        return self._count(name, self.syncs_at)

    def idle_ms(self, name: str):
        """Device-idle ms per unit inside the span `name`; None where the
        pass ran nothing on a device."""
        if name not in self.intervals or not self.has_device:
            return None
        total, gaps, i = 0.0, self.gaps, 0
        for s, e in self.intervals[name]:
            while i < len(gaps) and gaps[i][1] <= s:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < e:
                total += min(e, gaps[j][1]) - max(s, gaps[j][0])
                j += 1
        return total / 1e3 / self.units


def record(ctx) -> SpanReading:
    """One pass of `named_units` units with the host's operations and the
    card's activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .common import Spans
    from .timing import synchronize
    from ..run import kind_module

    kind = kind_module(ctx.traffic)
    device = ctx.s.device
    units = ctx.traffic["named_units"]
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        synchronize(device)
        with record_function(trace.WINDOW_MARK):
            kind.profiled_units(ctx.s, units, Spans(False))
            synchronize(device)
    path = Path(tempfile.gettempdir()) / f"perfbench_spans.{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = trace.load(path)
    finally:
        path.unlink()
    return SpanReading(events, units)


def of(ctx) -> SpanReading:
    """The context's reading, recorded on the first call."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = record(ctx)
    return ctx.program_spans
