#!/usr/bin/env python3
"""Per-mode step times of the unfused DG steps and the eval latency at
batch 1, for each detector family on one card (the port of
scripts/bench_detail.py).

    python3 scripts/bench_detail_torch.py [--family FRCNN|FCOS|both]
                                          [--iters 5]
    python3 scripts/bench_detail_torch.py --device cpu    # a smoke run

The unfused steps are the ones `Trainer(fused_pairs=False)` runs, the
CLI's `--reference_quirks` path: one step per DG mode 0-4
(`train/steps.py::make_train_step`), each with its sampling draws made
just before it, as `Trainer.train_epoch` makes them. Each family runs at
608x1216, batch 8, bf16 compute, ResNet-50 (3,4,6,3), random weights from a
seed (FrozenBatchNorm statistics from a batch), on the JAX script's batch:
3-29 gt per image (`utils/synthetic.dense_gt_batch`). Each mode: one call
warms up, then `--iters` calls are timed on the host clock from a
synchronised start to a synchronised end. The unfused DG cycle is 4 x
mode 0 + modes 1-4: 8 steps over 64 images. Eval: the predict on the
batch's first image, `--iters` calls, on the host clock around each
synchronised call (what a caller waits, launches included; the median)
and on the device (CUDA events around calls queued behind a device sleep,
`utils/timing.device_time_ms`).

Prints one JSON line. Without a card it exits non-zero and prints none,
unless `--device cpu` is given (64x128, blocks (1,1,1,1), batch 2,
float32: a check of the path, not a measurement of the card).
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ("FRCNN", "FCOS")
MODES = (0, 1, 2, 3, 4)


def run_family(family: str, dev, size: dict, iters: int) -> dict:
    """The unfused mode steps and the batch-1 predict of one family. ->
    {mode_ms, cycle_ms, cycle_images_per_sec, eval_b1_ms_host,
    eval_b1_ms_device, losses, calls}; `calls` counts every step and
    predict run (each kernel launch on the card is one of them)."""
    import numpy as np
    import torch

    from dgod_tpu_torch.models.dg_frcnn import batch_to_torch
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.optim import init_opt_state
    from dgod_tpu_torch.utils import synthetic, timing

    b = size["batch"]
    model, _ = synthetic.sized_model(family, dev, size)
    host = synthetic.dense_gt_batch(np.random.RandomState(0), b,
                                    size["canvas"], model.num_domains)
    batch = batch_to_torch(host, dev)
    g = batch["boxes"].shape[1]
    opt_config, lr = S.make_optimizer(family)
    opt_state = init_opt_state(dict(model.named_parameters()), opt_config)
    gen = torch.Generator(device=dev).manual_seed(1)
    calls = collections.Counter()
    mode_ms, losses = {}, {}
    for mode in MODES:
        step = S.make_train_step(model, mode, synthetic.REG_WEIGHTS,
                                 opt_config, lr)

        def one(n):
            nonlocal opt_state
            for _ in range(n):
                draws = model.make_draws(b, g, gen, with_rpn=mode == 0)
                opt_state, metrics = step(opt_state, batch, draws)
                calls[f"mode{mode}"] += 1
            return metrics

        one(1)  # cuDNN's and the allocator's warm-up
        metrics, ms = timing.host_ms(lambda: one(iters), dev)
        mode_ms[mode] = ms / iters
        losses[mode] = float(metrics["loss"])
        if not math.isfinite(losses[mode]):
            raise SystemExit(f"bench_detail_torch: {family} mode {mode}: "
                             f"non-finite loss {losses[mode]}")
    cycle_ms = 4 * mode_ms[0] + sum(mode_ms[m] for m in MODES[1:])
    images = 8 * b  # 8 steps of the cycle, one batch each

    one_image = {k: v[:1] for k, v in batch.items()}
    eval_step = S.make_eval_step(model)

    def predict():
        calls["predict"] += 1
        return eval_step(one_image)

    predict()  # warm-up
    host = [timing.host_ms(predict, dev)[1] for _ in range(iters)]
    device_ms = timing.device_time_ms(predict, dev, iters=iters, warmup=1)
    return {
        "mode_ms": {str(m): v for m, v in mode_ms.items()},
        "cycle_ms": cycle_ms,
        "cycle_images": images,
        "cycle_images_per_sec": images / (cycle_ms / 1e3),
        "eval_b1_ms_host": statistics.median(host),
        "eval_b1_ms_device": device_ms,
        "gt_per_image": batch["gt_valid"].sum(1).tolist(),
        "losses": {str(m): v for m, v in losses.items()},
        "calls": dict(calls),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", default="both",
                        choices=("FRCNN", "FCOS", "both"))
    parser.add_argument("--iters", type=int, default=5,
                        help="timed calls per mode and of the predict")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (a smoke run)")
    args = parser.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_detail_torch: no CUDA device; pass --device cpu for a "
              "smoke run", file=sys.stderr)
        return 1
    print(json.dumps(run(args, dev)))
    return 0


def run(args, dev) -> dict:
    """Every family of `args` on `dev`. -> the JSON line's object."""
    from dgod_tpu_torch.utils import synthetic, timing

    size = synthetic.SIZES[dev.type]
    families = FAMILIES if args.family == "both" else (args.family,)
    return {
        "script": "bench_detail_torch",
        "families": {f: run_family(f, dev, size, args.iters)
                     for f in families},
        "canvas": list(size["canvas"]), "batch": size["batch"],
        "block_counts": list(size["blocks"]),
        "dtype": str(size["dtype"]).replace("torch.", ""),
        "iters": args.iters, **timing.describe(dev),
    }


if __name__ == "__main__":
    sys.exit(main())
