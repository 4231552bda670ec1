"""Metrics logging (the port's copy of dgod_tpu/utils/logging.py's
MetricsLogger).

The reference has no train-loss logging and no throughput metrics
(SURVEY.md §5). MetricsLogger: append-only JSONL (step/epoch scoped), cheap
enough to call every step; it plays the role of the reference's TensorBoard
logger (PL default, train_driving_dg.py:163) with an analysis-friendly
format. Pass tb_dir (or set DGOD_TB_DIR) to also emit TensorBoard scalars,
so reference users keep their dashboards; without the tensorboard package
the mirror is off with a warning and the JSONL log continues.

`profile_steps` records the steps it encloses with torch.profiler and
writes one Chrome/Perfetto trace (the port of the JAX package's
`profile_steps`, which records a device trace with jax.profiler).

`span(name)` marks one layer of the program (a `dgod.*` name) in that
trace: while a torch.profiler records, a `record_function` range on the
profiler's own clock, beside the kernels and the CUDA runtime calls it
issued; otherwise one shared null context, so the spans cost a flag test
when nobody profiles.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = nullcontext()


def span(name: str):
    """A `record_function(name)` range while a torch.profiler records, else
    the shared null context. Callers pass a constant name: the spans sit at
    layer boundaries, on the hot path of every step."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class MetricsLogger:
    def __init__(self, path: Optional[str], tb_dir: Optional[str] = None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._tb = None
        tb_dir = tb_dir or os.environ.get("DGOD_TB_DIR") or None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tb_dir)
            except Exception as e:
                # tensorboard is optional, but the mirror was explicitly
                # requested — say why it will be missing instead of
                # leaving an empty directory to be discovered hours later
                print(f"WARNING: --tb_dir/DGOD_TB_DIR={tb_dir!r} requested "
                      f"but the TensorBoard mirror is disabled "
                      f"({type(e).__name__}: {e}); JSONL logging continues",
                      file=sys.stderr)
                self._tb = None
        self.t0 = time.time()

    def log(self, scope: str, step: int, metrics: Dict[str, Any]):
        if self._f is None and self._tb is None:
            return
        rec = {
            "t": round(time.time() - self.t0, 3),
            "scope": scope,
            "step": step,
        }
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("t", "scope", "step") or not isinstance(v, float):
                    continue
                self._tb.add_scalar(f"{scope}/{k}", v, step)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
        if self._tb:
            self._tb.close()
            self._tb = None


@contextmanager
def profile_steps(log_dir: str):
    """Record the enclosed steps with torch.profiler, on the host (CPU
    activity) and, where a card is there, on the card (CUDA activity), and
    write one Chrome/Perfetto trace into `log_dir`. Yields the trace's
    path; the file is written when the block ends (the card's queued work
    is waited for first, so its kernels are in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                 f"-{time.perf_counter_ns()}.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
