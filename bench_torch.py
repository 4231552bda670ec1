#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: DG training throughput (images/s)
and MFU for both detector families on one card.

    python3 bench_torch.py                 # the card
    python3 bench_torch.py --device cpu    # a smoke run at a small canvas

Each family runs the DG cycle as the training harness runs it
(`utils/synthetic.build_dg_cycle`, the cycle chip_smoke.py's main path
runs): the fused pairs (0,1) (0,2) (0,3) (0,4) through `train/steps.py`,
with the sampling draws made before each pair, at 608x1216, batch 8, bf16 compute, 3
domains, ResNet-50 (3,4,6,3), random weights from a seed. Each pair takes
its own synthetic uint8 batch with 2-8 boxes per image, already on the
device, and the FrozenBatchNorm statistics are calibrated from the first
(random convolutions under identity batch-norm diverge). One cycle warms
up; then at least 5 cycles are timed, each on the host clock from a
synchronised start to a synchronised end. A cycle holds 8 * batch images,
each pair counting its batch twice as `Trainer.train_epoch` does; a
family's images/s is the median over its cycles, and its `mfu` and
`model_tflops_per_sec` come from `utils.flops.train_mfu` (H100 SXM dense
bf16 peak). The headline `value` is the lower of the two families.

Prints one JSON line. On the CPU (a smoke run) the canvas is 64x128, the
batch 2, the backbone blocks (1,1,1,1) in float32, FRCNN samples as the
CPU tests do, and 1 cycle is timed; its MFU is null, since neither its
sizes nor its device are the count's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from dgod_tpu_torch.utils import synthetic

FAMILIES = ("FRCNN", "FCOS")
NUM_DOMAINS = 3
# the shared sizes of a card run and a CPU smoke run, and the cycles timed
SIZES = {dev: dict(size, cycles=5 if dev == "cuda" else 1)
         for dev, size in synthetic.SIZES.items()}


def bench_family(family: str, dev: torch.device, size: dict) -> dict:
    from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
    from dgod_tpu_torch.utils import flops, timing
    from dgod_tpu_torch.utils.synthetic import build_dg_cycle, run_dg_cycle

    canvas, b = size["canvas"], size["batch"]
    config = (FRCNNConfig(**size["frcnn"])
              if family == "FRCNN" and "frcnn" in size else None)
    dg = build_dg_cycle(family, dev, canvas=canvas, batch=b,
                        num_domains=NUM_DOMAINS,
                        block_counts=size["blocks"],
                        compute_dtype=size["dtype"], config=config,
                        n_batches=4)

    def cycle():
        return list(run_dg_cycle(dg).values())

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cycle_ms = []
    for i in range(1 + size["cycles"]):  # the first warms up
        metrics, ms = timing.host_ms(cycle, dev)
        bad = [k for m in metrics for k, v in m.items()
               if not torch.isfinite(v).all()]
        if bad:
            raise SystemExit(f"bench_torch: {family} cycle {i}: non-finite "
                             f"{sorted(set(bad))}")
        if i:
            cycle_ms.append(ms)
    images = dg.images
    med = statistics.median(cycle_ms)
    out = {
        "images_per_sec": images / (med / 1e3),
        "images_per_cycle": images,
        "cycle_ms_median": med,
        "cycle_ms_min": min(cycle_ms),
        "cycle_ms_max": max(cycle_ms),
        "cycle_ms": cycle_ms,
        "mfu": None,
        "model_tflops_per_sec": None,
        "flops_per_image": None,
    }
    if dev.type == "cuda":
        m = flops.train_mfu(family, canvas, b, out["images_per_sec"],
                            num_domains=NUM_DOMAINS)
        out.update(
            mfu=m["mfu"], model_tflops_per_sec=m["model_tflops_per_sec"],
            flops_per_image=m["flops_per_image"],
            peak_tflops=m["peak_tflops"],
            peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (a smoke run at a "
                             "small canvas)")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device; pass --device cpu for a smoke "
              "run", file=sys.stderr)
        return 1
    from dgod_tpu_torch.utils import timing

    size = SIZES[dev.type]
    families = {f: bench_family(f, dev, size) for f in FAMILIES}
    headline = min(FAMILIES, key=lambda f: families[f]["images_per_sec"])
    print(json.dumps({
        "metric": "dg_cycle_images_per_sec",
        "value": families[headline]["images_per_sec"],
        "unit": "images/s",
        "headline_family": headline,
        "families": families,
        "canvas": list(size["canvas"]),
        "batch": size["batch"],
        "block_counts": list(size["blocks"]),
        "dtype": str(size["dtype"]).replace("torch.", ""),
        "timed_cycles": size["cycles"],
        **timing.describe(dev),
        "tf32": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                 "cuda.matmul.allow_tf32":
                 torch.backends.cuda.matmul.allow_tf32},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
