#!/usr/bin/env python3
"""End-to-end DG training throughput through the real host data path, on
one card (the port of scripts/bench_e2e.py).

    python3 scripts/bench_e2e_torch.py [--family FRCNN|FCOS] [--steps 100]
        [--images 96] [--workers 8] [--batch 8] [--data_dir DIR]
        [--decode_cache_gb G] [--process_loader]
    python3 scripts/bench_e2e_torch.py --device cpu      # a smoke run

The benchmark's train cells (`perfbench/run.py`) time the DG cycle on
batches already on the card; this times the loop the CLI runs:

    PNG files on disk -> DrivingDataset (the port's C++ PNG decode, the
      reference CSV) -> TrainLoader (threads) or, with --process_loader,
      ProcessTrainLoader (a child process, pinned copy-out) -> the
      harness's pinned side-stream copies (`data/loader.device_prefetch`)
      -> fused pair steps (0,1) (0,2) (0,3) (0,4), each with its draws made
      just before it, as `Trainer.train_epoch` runs them

for `--steps` pair steps (two optimizer steps each) and reports:

- `e2e_ips`: images/s of that loop, counting `steps x 2 x batch` images
  (each pair uses its batch twice), the accounting of `Trainer.train_epoch`
  and of the JAX script;
- `device_ips`: the same pairs on one batch resident on the card;
- `host_ips`: the loader alone over one epoch, each batch's images once;
- `occupancy` = e2e_ips / device_ips (1.0: the host is hidden).

The images are `--images` photograph-like 1024x2048 PNGs whose rows cycle
through the five PNG filters (`utils/synthetic.write_png_dataset`, reused
from `--data_dir` when made with the same parameters), read as three
source domains that share the files, with the loader's duplicate emission
off (`loader.dg = False`), as under fused pairs. The model: 608x1216, bf16
compute, ResNet-50 (3,4,6,3), random weights from a seed, FrozenBatchNorm
statistics from a batch of these images (from those of random images the
first SGD steps diverge). Four pairs through the loader warm up
first. With `--decode_cache_gb` each domain keeps its decoded images
(GiB per domain): the cache is filled before the timed run (the process
loader's child owns its own, so one epoch is drained there first), which
measures the steady state of epochs >= 2.

Prints one JSON line. Without a card it exits non-zero and prints none,
unless `--device cpu` is given: a smoke run at the JAX script's --smoke
sizes (64x128 canvas from 128x256 PNGs, blocks (1,1,1,1), batch 2, at most
6 steps and 16 images, float32).

A loader child re-runs this file's top level, so nothing there imports
torch: a child that imports it starts ~3x slower.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIRS = (1, 2, 3, 4)
# the JAX script's --smoke sizes: canvas, source images, the transforms'
SMOKE_T = dict(CANVAS=(64, 128), TRAIN_SIZE=(60, 120), MIN_SIZE=60,
               MAX_SIZE=120, MIN_AREA=4.0)
SMOKE_SRC = (128, 256)
FULL_SRC = (1024, 2048)  # Cityscapes' PNG size


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="FRCNN", choices=("FRCNN", "FCOS"))
    ap.add_argument("--steps", type=int, default=100,
                    help="timed pair steps (2 optimizer steps each)")
    ap.add_argument("--images", type=int, default=96,
                    help="unique source PNGs (shared by the 3 domains)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data_dir", default=None,
                    help="where the PNGs are written (default: a folder "
                         "in the system's temporary directory)")
    ap.add_argument("--decode_cache_gb", type=float, default=0.0,
                    help="decoded-image cache per domain (GiB): the "
                         "steady state of epochs >= 2")
    ap.add_argument("--process_loader", action="store_true",
                    help="ProcessTrainLoader (a child process) instead of "
                         "TrainLoader's threads")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (a smoke run)")
    return ap.parse_args(argv)


def run(args, dev) -> dict:
    """The e2e, device-only and host-only rates of `args` on `dev`. ->
    the JSON line's object; `calls` counts the pair steps run (each
    kernel launch on the card is one of them)."""
    import collections
    import math
    import tempfile

    import torch

    from dgod_tpu_torch.data import transforms as T
    from dgod_tpu_torch.data.dataset import ConcatDataset, DrivingDataset
    from dgod_tpu_torch.data.loader import (ProcessTrainLoader, TrainLoader,
                                            device_prefetch)
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.optim import init_opt_state
    from dgod_tpu_torch.utils import synthetic, timing

    size = dict(synthetic.SIZES[dev.type])
    smoke = dev.type == "cpu"
    if smoke:
        args.steps, args.images = min(args.steps, 6), min(args.images, 16)
        args.batch = size["batch"]
    size["batch"] = args.batch
    saved = {k: getattr(T, k) for k in SMOKE_T}
    if smoke:  # the transforms read these module globals at call time
        for k, v in SMOKE_T.items():
            setattr(T, k, v)
    data_dir = args.data_dir or os.path.join(
        tempfile.gettempdir(), "dgod_e2e_torch_data")
    loader = None
    try:
        src_hw = SMOKE_SRC if smoke else FULL_SRC
        t = time.perf_counter()
        csv_path = synthetic.write_png_dataset(data_dir, args.images, src_hw)
        write_s = time.perf_counter() - t
        # DrivingDataset joins root and name as they are
        root = data_dir.rstrip("/") + "/"
        cache_bytes = int(args.decode_cache_gb * (1 << 30))
        ds = ConcatDataset([
            DrivingDataset(csv_path, root, domain=d,
                           decode_cache_bytes=cache_bytes)
            for d in range(3)])
        if cache_bytes and not args.process_loader:
            for i in range(len(ds)):  # the steady state of epochs >= 2
                ds[i]

        # FrozenBatchNorm's statistics from a batch of these images
        first = TrainLoader(ds, args.batch, dg=False,
                            num_workers=args.workers).epoch()
        calibration = next(first)["image"]
        first.close()
        model, _ = synthetic.sized_model(args.family, dev, size,
                                         calibration_images=calibration)
        del calibration
        opt_config, lr = S.make_optimizer(args.family)
        opt_state = init_opt_state(dict(model.named_parameters()),
                                   opt_config)
        pairs = {k: S.make_pair_step(model, k, synthetic.REG_WEIGHTS,
                                     opt_config, lr) for k in PAIRS}
        gen = torch.Generator(device=dev).manual_seed(0)
        calls = collections.Counter()
        i_pair = 0

        def pair(batch):
            """The next fused pair on `batch`, as Trainer.train_epoch runs
            it under fused pairs."""
            nonlocal opt_state, i_pair
            k = PAIRS[i_pair % 4]
            i_pair += 1
            b, g = batch["boxes"].shape[:2]
            d0 = model.make_draws(b, g, gen, with_rpn=True)
            dk = model.make_draws(b, g, gen, with_rpn=False)
            opt_state, metrics = pairs[k](opt_state, batch, d0, dk)
            calls[f"pair{k}"] += 1
            return metrics

        # the fused pair consumes each batch once (Trainer turns dg off)
        if args.process_loader:
            loader = ProcessTrainLoader(ds, args.batch, dg=False,
                                        num_workers=args.workers,
                                        pin_memory=dev.type == "cuda")
            if cache_bytes:  # the child fills its own cache
                for _ in loader.epoch():
                    pass
        else:
            loader = TrainLoader(ds, args.batch, dg=False,
                                 num_workers=args.workers)

        def batches(n):
            """Epochs of the real loader through the harness's copies, `n`
            batches in all."""
            got = 0
            while got < n:
                for b in device_prefetch(loader.epoch(), dev):
                    yield b
                    got += 1
                    if got >= n:
                        return

        def check(metrics, what):
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise SystemExit(f"bench_e2e_torch: {what}: non-finite "
                                 f"loss {loss}")

        for b in batches(len(PAIRS)):  # warm-up: each pair once
            metrics = pair(b)
        check(metrics, "warm-up")

        def e2e():
            for b in batches(args.steps):
                m = pair(b)
            return m

        metrics, e2e_ms = timing.host_ms(e2e, dev)
        check(metrics, "e2e")

        resident = next(iter(batches(1)))

        def on_card():
            for _ in range(args.steps):
                m = pair(resident)
            return m

        metrics, dev_ms = timing.host_ms(on_card, dev)
        check(metrics, "device-only")
        del resident

        n_img = 0
        t = time.perf_counter()
        for b in loader.epoch():
            n_img += b["image"].shape[0]
        host_s = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            setattr(T, k, v)
        if loader is not None and hasattr(loader, "close"):
            loader.close()

    images = args.steps * 2 * args.batch
    e2e_ips = images / (e2e_ms / 1e3)
    device_ips = images / (dev_ms / 1e3)
    return {
        "script": "bench_e2e_torch",
        "family": args.family,
        "e2e_ips": e2e_ips,
        "device_ips": device_ips,
        "host_ips": n_img / host_s,
        "occupancy": e2e_ips / device_ips,
        "images": images,
        "pair_steps": args.steps,
        "batch": args.batch,
        "workers": args.workers,
        "unique_images": args.images,
        "source_hw": list(src_hw),
        "dataset_write_s": write_s,
        "decode_cache_gb": args.decode_cache_gb,
        "process_loader": bool(args.process_loader),
        "host_cores": len(os.sched_getaffinity(0)),
        "calls": dict(calls),
        "canvas": list(size["canvas"]), **timing.describe(dev),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench_e2e_torch: no CUDA device; pass --device cpu for a "
              "smoke run", file=sys.stderr)
        return 1
    print(json.dumps(run(args, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
