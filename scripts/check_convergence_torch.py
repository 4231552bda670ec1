"""Convergence proof of the PyTorch/CUDA port on the card: it LEARNS, end
to end.

Trains both families, non_dg and dg, on generated detectable shapes until
train-set mAP@0.5 >= 0.9, through the port's harness (TrainLoader ->
Trainer.train_epoch -> Trainer.validate -> COCO mAP), with the recipe and
settings of scripts/check_convergence.py: 600x1200 images in a 608x1216
canvas, 16 per domain, 2 domains, batch 8, ResNet-50 (3,4,6,3), at most
400 epochs, from random weights (model seed 0) with FrozenBatchNorm at its
identity init; FRCNN with a 600-step LR warm-up (from scratch it diverges
at the reference's raw SGD lr).

Under this recipe FCOS at full depth learns or stalls by the draw of its
init, in both packages: the JAX package started from the port's seed-0
init stalls as the port does (scripts/compare_learning_jax_torch.py,
PERF.md). `--seed` draws another init; `--calibrate_bn` takes the
FrozenBatchNorm statistics from the first images of the training set
before the first step (`utils/synthetic.calibrate_frozen_bn`, as
chip_smoke.py's main path and the bench do), a stand-in for the
pretrained statistics the reference always starts from.

Data: coloured axis-aligned rectangles on per-domain-tinted noise, the
class the colour (4 classes); the port's own copy of the JAX script's
`ShapesDataset`, with the same RandomState draws, so both see the same
images.

    python3 scripts/check_convergence_torch.py                # all four
    python3 scripts/check_convergence_torch.py --only FCOS:dg # one combo
    python3 scripts/check_convergence_torch.py --smoke        # tiny size
    python3 scripts/check_convergence_torch.py --only FCOS:non_dg --seed 1

`--smoke` is the JAX smoke size (120x240 in 128x256, 8 per domain, batch
4, blocks (1,1,1,1), FCOS non_dg, at most 60 epochs, target 0.6). Runs on
the card unless given `--device cpu`. Appends a record of the invocation
(its settings, each run's curve, the card's name and power limit) to the
`proofs` list of convergence_results_torch.json (or `--out`); exits 0
when every run reached its target.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# class id -> RGB colour (distinct, far apart in colour space)
PALETTE = {
    1: (220, 40, 40),
    2: (40, 200, 60),
    3: (50, 80, 230),
    4: (235, 220, 50),
}
DOMAIN_TINT = {0: (30, 30, 30), 1: (90, 70, 20)}

FULL = dict(image_hw=(600, 1200), canvas=(608, 1216), n_per_domain=16,
            batch_size=8, block_counts=(3, 4, 6, 3), max_epochs=400,
            target=0.9)
SMOKE = dict(image_hw=(120, 240), canvas=(128, 256), n_per_domain=8,
             batch_size=4, block_counts=(1, 1, 1, 1), max_epochs=60,
             target=0.6)
# half the full side: the smallest size at which the JAX package's FRCNN
# is known to reach train mAP@0.5 0.6 (epoch 98 of 100 on the CPU, from
# scripts/compare_learning_jax_torch.py); chip_smoke.py's FRCNN learn phase
MID = dict(FULL, image_hw=(300, 600), canvas=(320, 608), max_epochs=100,
           target=0.6)
COMBOS = (("FCOS", False), ("FCOS", True), ("FRCNN", False), ("FRCNN", True))
FRCNN_WARMUP = 600


class ShapesDataset:
    """Rectangles-on-noise; detection target = (box, colour class)."""

    def __init__(self, n: int, domain: int, image_hw, seed: int = 0,
                 min_frac: float = 0.12, max_frac: float = 0.35,
                 max_boxes: int = 3):
        rng = np.random.RandomState(seed * 7 + domain)
        h, w = image_hw
        self.images, self.boxes, self.labels = [], [], []
        self.domain = domain
        for _ in range(n):
            img = rng.randint(0, 60, (h, w, 3)).astype(np.int16)
            img += np.asarray(DOMAIN_TINT[domain], np.int16)
            k = rng.randint(1, max_boxes + 1)
            boxes, labels = [], []
            for _ in range(k):
                bw = int(rng.uniform(min_frac, max_frac) * w)
                bh = int(rng.uniform(min_frac, max_frac) * h)
                x1 = rng.randint(0, w - bw)
                y1 = rng.randint(0, h - bh)
                cls = int(rng.randint(1, len(PALETTE) + 1))
                color = np.asarray(PALETTE[cls], np.int16)
                jitter = rng.randint(-15, 15, (bh, bw, 3))
                img[y1:y1 + bh, x1:x1 + bw] = color + jitter
                boxes.append([x1, y1, x1 + bw, y1 + bh])
                labels.append(cls)
            self.images.append(np.clip(img, 0, 255).astype(np.uint8))
            self.boxes.append(np.asarray(boxes, np.float32))
            self.labels.append(np.asarray(labels, np.int32))

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return (self.images[idx].copy(), self.boxes[idx].copy(),
                self.labels[idx].copy(), self.domain)


def build_trainer(family: str, dg: bool, image_hw, canvas, n_per_domain,
                  batch_size, warmup_steps, block_counts, tmpdir,
                  device=None, calibrate_bn=False, seed=0, init_state=None,
                  compute_dtype=None):
    """The port's Trainer on two ShapesDatasets, its model drawn from
    `seed` (or, given `init_state`, loaded from that `state_dict`) and,
    with `calibrate_bn`, its FrozenBatchNorm statistics taken from the
    training set's first images. Sets the geometry globals of the port's
    data/transforms.py in place (callers that must keep them restore
    them). `compute_dtype` defaults to the model's (bf16)."""
    from dgod_tpu_torch.data import transforms as T

    T.CANVAS = canvas
    T.TRAIN_SIZE = image_hw
    T.MIN_SIZE = min(image_hw)
    T.MAX_SIZE = max(image_hw)
    T.MIN_AREA = 4.0

    from dgod_tpu_torch.data.dataset import ConcatDataset
    from dgod_tpu_torch.data.loader import EvalLoader, TrainLoader
    from dgod_tpu_torch.train.harness import Trainer

    train_ds = ConcatDataset([
        ShapesDataset(n_per_domain, 0, image_hw, seed=1),
        ShapesDataset(n_per_domain, 1, image_hw, seed=1),
    ])
    kw = dict(num_classes=9, num_domains=2, canvas=canvas,
              backbone_block_counts=block_counts, device=device, seed=seed)
    if compute_dtype is not None:
        kw["compute_dtype"] = compute_dtype
    if family == "FCOS":
        from dgod_tpu_torch.models.dg_fcos import DGFCOSModel

        model = DGFCOSModel(**kw)
        val_resize = True
    else:
        from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel

        model = DGFRCNNModel(**kw)
        val_resize = False
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)

    train_loader = TrainLoader(train_ds, batch_size, dg, num_workers=4)
    # the TRAIN set: overfitting is the point (a learning proof, not
    # generalisation); eval at batch 8 for speed
    val_loader = EvalLoader(train_ds, min(8, batch_size), val_resize,
                            num_workers=4)
    if calibrate_bn:
        from dgod_tpu_torch.utils.synthetic import calibrate_frozen_bn

        batches = iter(val_loader)
        images = next(batches)["image"]
        batches.close()
        calibrate_frozen_bn(model, torch.from_numpy(images).to(
            next(model.parameters()).device))
    return Trainer(
        model, train_loader, val_loader, dg=dg, max_epochs=0,
        ckpt_path=os.path.join(tmpdir, f"{family}_{dg}.ckpt"),
        log_every=10 ** 9, warmup_steps=warmup_steps, device=device)


def run_one(family: str, dg: bool, *, image_hw, canvas, n_per_domain,
            batch_size, warmup_steps, block_counts, max_epochs, target,
            tmpdir, device=None, calibrate_bn=False, seed=0,
            init_state=None) -> dict:
    t0 = time.time()
    trainer = build_trainer(family, dg, image_hw, canvas, n_per_domain,
                            batch_size, warmup_steps, block_counts, tmpdir,
                            device, calibrate_bn, seed, init_state)
    curve = []
    best = -1.0
    for epoch in range(max_epochs):
        stats = trainer.train_epoch()
        m = trainer.validate()
        entry = {
            "epoch": epoch,
            "step": trainer.global_step,
            "map_50": round(float(m["map_50"]), 4),
            "loss": round(stats.get("loss", float("nan")), 4),
            "img_per_sec": round(stats["images_per_sec"], 1),
        }
        if dg and "loss0" in stats:
            entry["loss0"] = round(stats["loss0"], 4)
        curve.append(entry)
        best = max(best, float(m["map_50"]))
        print(f"[{family} {'dg' if dg else 'non_dg'}] epoch {epoch} "
              f"step {trainer.global_step} mAP@0.5 {m['map_50']:.3f} "
              f"loss {stats.get('loss', float('nan')):.3f}", flush=True)
        if best >= target:
            break
    return {
        "family": family,
        "exp": "dg" if dg else "non_dg",
        "best_map_50": round(best, 4),
        "target": target,
        "reached": best >= target,
        "epochs": len(curve),
        "steps": trainer.global_step,
        "wall_s": round(time.time() - t0, 1),
        "curve": curve,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", action="append", default=None,
                        metavar="FAMILY:EXP",
                        help="run one combo, e.g. FCOS:dg (repeatable)")
    parser.add_argument("--smoke", action="store_true",
                        help="the JAX smoke size, FCOS non_dg")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="the model's init seed")
    parser.add_argument("--calibrate_bn", action="store_true",
                        help="FrozenBatchNorm statistics from the first "
                             "batch (the JAX script leaves them at "
                             "identity)")
    parser.add_argument("--out", default=os.path.join(
        REPO, "convergence_results_torch.json"))
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("check_convergence_torch: no CUDA device", file=sys.stderr)
        return 1
    from dgod_tpu_torch.utils import timing

    kw = SMOKE if args.smoke else FULL
    combos = [("FCOS", False)] if args.smoke else list(COMBOS)
    if args.only:
        combos = [(f, e == "dg") for f, e in
                  (o.split(":") for o in args.only)]

    results = []
    with tempfile.TemporaryDirectory() as tmpdir:
        for family, dg in combos:
            warmup = FRCNN_WARMUP if family == "FRCNN" else 0
            results.append(run_one(family, dg, warmup_steps=warmup,
                                   tmpdir=tmpdir, device=dev,
                                   calibrate_bn=args.calibrate_bn,
                                   seed=args.seed, **kw))

    card = timing.card(dev)
    proofs = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            proofs = json.load(f)["proofs"]
    proofs.append({"card": card, "torch": torch.__version__,
                   "settings": dict(
                       {k: list(v) if isinstance(v, tuple) else v
                        for k, v in kw.items()}, seed=args.seed,
                       frozen_bn="calibrated" if args.calibrate_bn
                       else "identity"),
                   "runs": results})
    with open(args.out, "w") as f:
        json.dump({"proofs": proofs}, f, indent=1)
    ok = all(r["reached"] for r in results)
    print(card)
    for r in results:
        print(f"{r['family']:6s} {r['exp']:7s} best mAP@0.5 "
              f"{r['best_map_50']:.3f} in {r['epochs']} epochs, "
              f"{r['steps']} steps ({r['wall_s']}s) -> "
              f"{'PASS' if r['reached'] else 'FAIL'}")
    print(("PASS" if ok else "FAIL") + f": curves in {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
