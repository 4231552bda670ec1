"""Metrics logging (the port's copy of dgod_tpu/utils/logging.py's
MetricsLogger).

The reference has no train-loss logging and no throughput metrics
(SURVEY.md §5). MetricsLogger: append-only JSONL (step/epoch scoped), cheap
enough to call every step; it plays the role of the reference's TensorBoard
logger (PL default, train_driving_dg.py:163) with an analysis-friendly
format. Pass tb_dir (or set DGOD_TB_DIR) to also emit TensorBoard scalars,
so reference users keep their dashboards; without the tensorboard package
the mirror is off with a warning and the JSONL log continues.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


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
