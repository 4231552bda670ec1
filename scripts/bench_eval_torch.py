#!/usr/bin/env python3
"""Eval-path benchmark of the port on one card (the port of
scripts/bench_eval.py): predict latency per image at batch 1 and batch 8,
the pipelined validation sweep as `Trainer.validate` runs it, and where a
predict's time goes.

    python3 scripts/bench_eval_torch.py [--family FRCNN|FCOS|both]
        [--iters 30] [--sweep_batches 16]
    python3 scripts/bench_eval_torch.py --device cpu    # a smoke run

The validation sweep runs after every training epoch (early-stop patience
10 means at least 10 sweeps per run), so its rate counts toward a run's
card-time. Each family runs at 608x1216, bf16 compute, ResNet-50
(3,4,6,3), random weights from a seed (FrozenBatchNorm statistics from a
batch), on the JAX script's batches (3-29 gt per image, domain 0;
`utils/synthetic.dense_gt_batch`, seeds 0-3).

- **Latency** at batch 1 and 8: the eval step (`train/steps.py::
  make_eval_step`, `predict` under no_grad) on a batch on the card, timed
  two ways: on the host clock around each synchronised call (what a caller
  waits, launch cost included; the median of `--iters`), and on the
  device (CUDA events around `--iters` calls queued behind a device sleep,
  `utils/timing.device_time_ms`, which hides the launch cost).
- **The sweep**: `Trainer.validate` itself over `--sweep_batches` host
  batches of 8 drawn in turn from 4 distinct ones: each batch pinned and
  copied to the card, its predict issued before the previous batch's
  detections are matched on the host, the mAP@0.5 computed there. One
  sweep warms up; the next is timed on the host clock. Reports images/s
  and the sweep's mAP (random weights: near 0).
- **Stages** of a predict at batch 1 and at batch 8 (the first image of
  the sweep's first batch, and that batch), by successive prefixes, each
  timed on the device as above: FRCNN backbone+FPN, + RPN heads, + proposal decode
  and NMS (K5), + RoIAlign (K1), + box head, + postprocess (K6, the full
  predict); FCOS the forward, + postprocess (K6). A stage's cost is its
  prefix's time less the one before (a small stage can read below 0
  within the timing's noise). Then the copy of a batch's detections to
  the host as `Trainer.validate` makes it (into pinned memory,
  non-blocking, waited on), after a synchronised predict, on the host
  clock (the median).

Prints one JSON line. Without a card it exits non-zero and prints none,
unless `--device cpu` is given (64x128, blocks (1,1,1,1), batch 2 in the
sweep and the stages, float32: a check of the path, not a measurement).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = ("FRCNN", "FCOS")
DISTINCT = 4  # distinct host batches behind the sweep


def eval_batches(n: int, b: int, canvas, distinct: int = DISTINCT):
    """`n` host batches of `b`, drawn in turn from `distinct` ones (the JAX
    script's seeds 0..distinct-1)."""
    import numpy as np

    from dgod_tpu_torch.utils.synthetic import dense_gt_batch

    made = [dense_gt_batch(np.random.RandomState(s), b, canvas,
                           domains=False) for s in range(distinct)]
    return [made[i % distinct] for i in range(n)]


def make_trainer(model, val_batches, dev, root: str):
    """A Trainer of `model` on `dev` whose validation loader yields
    `val_batches` (its checkpoint path under `root`, never written)."""
    from dgod_tpu_torch.train.harness import Trainer
    from dgod_tpu_torch.utils.synthetic import HostBatches

    return Trainer(model, HostBatches(val_batches[:1]),
                   HostBatches(val_batches), device=dev,
                   ckpt_path=os.path.join(root, "unused.ckpt"))


def stage_fns(model, batch):
    """The successive prefixes of a predict on `batch`: [(name, fn)]."""
    if model.name == "FCOS":
        return [("forward", lambda: model(batch["image"])),
                ("+postprocess (K6)", lambda: model.predict(batch))]
    det = model.detector

    def feats():
        return det.features(model.normalize(batch["image"]))[0]

    def rpn():
        f = feats()
        return f, det.rpn_forward(f)

    def props():
        f, (obj, deltas) = rpn()
        p, pv, _ = det.generate_proposals(obj, deltas, batch["image_size"],
                                          training=False)
        return f, p

    def roi():
        f, p = props()
        return det.box_features(f, p)

    def head():
        return det.box_predictions(roi())

    return [("backbone+FPN", feats), ("+RPN heads", rpn),
            ("+proposal decode/NMS (K5)", props), ("+RoIAlign (K1)", roi),
            ("+box head", head),
            ("+postprocess (K6)", lambda: model.predict(batch))]


def run_family(family: str, dev, size: dict, iters: int,
               sweep_batches: int) -> dict:
    """Latency, sweep and stages of one family. `calls` counts every
    predict and every stage prefix run (each kernel launch on the card is
    one of them)."""
    import torch

    from dgod_tpu_torch.models.dg_frcnn import batch_to_torch
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.utils import synthetic, timing

    b = size["batch"]
    model, _ = synthetic.sized_model(family, dev, size)
    eval_step = S.make_eval_step(model)
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    out = {}
    for n in sorted({1, b}):
        batch = batch_to_torch(eval_batches(1, n, size["canvas"])[0], dev)
        predict = counted("predict", lambda: eval_step(batch))
        predict()  # warm-up
        host = [timing.host_ms(predict, dev)[1] for _ in range(iters)]
        out[f"batch{n}_ms_per_image_host"] = statistics.median(host) / n
        out[f"batch{n}_ms_per_image_device"] = timing.device_time_ms(
            predict, dev, iters=iters, warmup=1) / n
        del batch

    host_batches = eval_batches(sweep_batches, b, size["canvas"])
    with tempfile.TemporaryDirectory() as root:
        trainer = make_trainer(model, host_batches, dev, root)
        trainer.eval_step = counted("predict", trainer.eval_step)
        trainer.validate()  # warm-up
        timing.synchronize(dev)
        t = time.perf_counter()
        val = trainer.validate()
        sweep_s = time.perf_counter() - t
        out["sweep_images_per_sec"] = sweep_batches * b / sweep_s
        out["sweep_map_50"] = float(val["map_50"])
        out["sweep_batches"] = sweep_batches

        batch = batch_to_torch(host_batches[0], dev)
        stages = {}
        with torch.no_grad():
            for n in sorted({1, b}):
                part = {k: v[:n] for k, v in batch.items()}
                stages[f"batch{n}"], prev = {}, 0.0
                for name, fn in stage_fns(model, part):
                    ms = timing.device_time_ms(counted(name, fn), dev,
                                               iters=iters, warmup=1)
                    stages[f"batch{n}"][name] = {"cumulative_ms": ms,
                                                 "stage_ms": ms - prev}
                    prev = ms
            predict = counted("predict", lambda: eval_step(batch))

            def copy(dets):
                host, done = trainer._fetch(dets)
                if done is not None:
                    done.synchronize()
                return host

            copy_ms = []
            for _ in range(iters + 1):  # the first warms up
                dets, _ = timing.host_ms(predict, dev)
                copy_ms.append(timing.host_ms(lambda: copy(dets), dev)[1])
        out["stages"] = stages
        out["copy_ms_host"] = statistics.median(copy_ms[1:])
    out["calls"] = dict(calls)
    return out


def run(args, dev) -> dict:
    """Every family of `args` on `dev`. -> the JSON line's object."""
    from dgod_tpu_torch.utils import synthetic, timing

    size = synthetic.SIZES[dev.type]
    families = FAMILIES if args.family == "both" else (args.family,)
    return {
        "script": "bench_eval_torch",
        "families": {f: run_family(f, dev, size, args.iters,
                                   args.sweep_batches) for f in families},
        "canvas": list(size["canvas"]), "batch": size["batch"],
        "block_counts": list(size["blocks"]),
        "dtype": str(size["dtype"]).replace("torch.", ""),
        "iters": args.iters, **timing.describe(dev),
        "clocks": "host: a synchronised call on the host clock, launches "
                  "included; device: CUDA events, calls queued behind a "
                  "device sleep",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--family", default="both",
                        choices=("FRCNN", "FCOS", "both"))
    parser.add_argument("--iters", type=int, default=30,
                        help="timed calls per latency and per stage")
    parser.add_argument("--sweep_batches", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (a smoke run)")
    args = parser.parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_eval_torch: no CUDA device; pass --device cpu for a "
              "smoke run", file=sys.stderr)
        return 1
    print(json.dumps(run(args, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
