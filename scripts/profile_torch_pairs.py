#!/usr/bin/env python3
"""Where the time of one DG cycle goes on the card (dgod_tpu_torch).

    python3 scripts/profile_torch_pairs.py [--family FRCNN|FCOS] [--out DIR]
                                           [--trace]

Builds the port's kernels and drives chip_smoke.py's main path of one
family through its own `build_main_path` and `dg_cycle` (so the
configuration is chip_smoke's: ResNet-50 (3,4,6,3), 608x1216, 3 domains,
bf16, batch 8, random weights from seed 0 with FrozenBatchNorm statistics
taken from the batch; FRCNN: default FRCNNConfig, SGD; FCOS: P3..P7, 9
classes, Adam): one DG cycle of fused pairs (0,1)..(0,4) and a predict to
warm up, one timed on the host clock, and one under torch.profiler.

Prints the host-clock time of each pair step and of the predict, the
device's busy time (the sum of its kernels, memcpys and memsets in the
profiled cycle) and its idle share against the timed cycle, the profiled
cycle's device launches and host syncs (CUDA synchronize calls, and the
device-to-host scalar reads that make most of them), the device time by
kernel category and the 25 kernels with the most device time, and the
port's kernel launches in the timed cycle as the wrappers count them
(chip_smoke.read_counts; for FCOS, K4's launches and device time per
cycle). Writes the full table (and with --trace a chrome trace) under
--out/<family>. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

# kernel name -> category, first match wins; K2's pattern also takes the
# names of its earlier atomic design (bwd_kernel, cast_bf16_kernel), so that
# an older checkout profiles into the same categories
CATEGORIES = (
    ("K1 roi_align_fwd (port)", r"\bfwd_kernel"),
    ("K2 roi_align_bwd (port)",
     r"bwd_(geometry|gather)_kernel|\bbwd_kernel|cast_bf16_kernel"),
    ("K4 fcos_match (port)", r"fcos_match_kernel"),
    ("K3 iou_match (port)", r"best_kernel|match_kernel|init_best"),
    ("K6 nms_topk (port)", r"nms_topk_kernel"),
    ("K5 decode_nms (port)", r"\b(decode|mask|scan)_kernel\b"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"gemm|cutlass|xmma|cudnn|conv|wgrad|dgrad|fprop|sm90_|nhwc"),
    ("sort / top-k", r"[Ss]ort|radix|topk|bitonic"),
    ("gather / scatter / index", r"index|gather|scatter|take"),
    ("reduce", r"[Rr]educe"),
    ("elementwise / copy", r"elementwise|vectorized|Memcpy|Memset|copy|fill"),
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def device_time_us(evt) -> float:
    """Device time of a kernel entry of key_averages(), in us."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("FRCNN", "FCOS"), default="FRCNN")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile"))
    ap.add_argument("--trace", action="store_true",
                    help="also write the chrome trace (tens of MB)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pairs: no CUDA device", file=sys.stderr)
        return 1
    from dgod_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    path = cs.build_main_path(torch.device("cuda"), args.family)
    if args.family == "FRCNN":
        with torch.no_grad():
            feats, _ = path.model.detector.features(
                path.model.normalize(path.batches[0]["image"]))
        print("P2..P5 are contiguous NHWC views (no copy before K1): "
              f"{[bool(f.is_contiguous()) for f in feats[:4]]}")
        del feats

    def finite(k, metrics, _state, _ms):
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise SystemExit(f"profile_torch_pairs: non-finite loss in "
                             f"pair (0,{k})")

    def cycle():
        pair_ms, pred_ms, _ = cs.dg_cycle(path, after_pair=finite)
        times = {f"(0,{k})": ms for k, ms in pair_ms.items()}
        times["predict"] = pred_ms
        return times

    cycle()  # warm-up: cuDNN autotuning, allocator growth
    cs.reset_counts()
    times = cycle()  # the host-clock times, without the profiler's cost
    launches = cs.read_counts()
    wall_ms = sum(times.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_times = cycle()

    out = Path(args.out) / args.family
    out.mkdir(parents=True, exist_ok=True)
    if args.trace:
        prof.export_chrome_trace(str(out / "dg_cycle_trace.json"))
    # kernel, memcpy and memset entries only: an operator's entry repeats
    # the device time of the kernels it launched
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    host = {e.key: e.count for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU}
    syncs = sum(n for k, n in host.items() if re.fullmatch(
        r"cuda(Stream|Device|Event)Synchronize", k))
    busy_ms = sum(device_time_us(e) for e in events) / 1e3
    if busy_ms <= 0:
        raise SystemExit("profile_torch_pairs: the profiler recorded no "
                         "device time")
    by_cat = collections.Counter()
    for e in events:
        by_cat[category(e.key)] += device_time_us(e) / 1e3
    events.sort(key=device_time_us, reverse=True)
    with open(out / "dg_cycle_kernels.txt", "w") as f:
        for e in events:
            f.write(f"{device_time_us(e) / 1e3:10.3f} ms {e.count:6d}x "
                    f"{e.key}\n")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    print(f"{args.family} DG cycle")
    print("host-clock ms: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in times.items()))
    print("host-clock ms under the profiler: " + ", ".join(
        f"{k} {v:.1f}" for k, v in prof_times.items()))
    print(f"DG cycle: host clock {wall_ms:.1f} ms (sum of the synchronised "
          f"steps), device busy {busy_ms:.1f} ms (profiler), idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    print(f"profiled cycle: {sum(e.count for e in events)} device launches "
          f"(kernels, memcpys, memsets); {syncs} host syncs "
          f"(cuda*Synchronize), {host.get('aten::_local_scalar_dense', 0)} "
          f"device-to-host scalar reads, {host.get('aten::equal', 0)} "
          f"torch.equal")
    print("device time by category (ms, share of busy):")
    for cat, ms in by_cat.most_common():
        print(f"  {ms:9.2f}  {ms / busy_ms:6.3f}  {cat}")
    print(f"the port's kernel launches in the timed cycle (wrappers): "
          f"{launches}")
    if args.family == "FCOS":
        k4 = [e for e in events if category(e.key).startswith("K4")]
        print(f"K4 per FCOS DG cycle: {launches['K4']} launches, "
              f"{sum(device_time_us(e) for e in k4) / 1e3:.4f} ms device "
              f"time (profiled cycle)")
    print("the port's kernels (ms, launches, category, name):")
    for e in events:
        cat = category(e.key)
        if "(port)" in cat:
            print(f"  {device_time_us(e) / 1e3:9.3f} {e.count:6d}  {cat}: "
                  f"{e.key[:80]}")
    print("top kernels by device time (ms, launches, name):")
    for e in events[:25]:
        print(f"  {device_time_us(e) / 1e3:9.2f} {e.count:6d}  {e.key[:110]}")
    print(f"wrote {out / 'dg_cycle_kernels.txt'}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
