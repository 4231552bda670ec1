"""Synthetic inputs for runs from random weights (chip_smoke.py,
bench_torch.py, the measurement and split scripts): training batches of
uint8 images with 2-8 boxes each (`synthetic_batch`) or with 3-30
(`dense_gt_batch`, the JAX measurement scripts' batch), FrozenBatchNorm
statistics taken from a batch, the DG training cycle built on them
(`build_dg_cycle`, `run_dg_cycle`), the one that chip_smoke.py's main
path and the bench both time, and a dataset on disk in the real datasets'
format: photograph-like PNGs whose rows cycle through the five PNG
filters, with the reference CSV (`write_png_dataset`)."""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
import torch

from ..models.resnet import FrozenBatchNorm


def synthetic_batch(rng: np.random.RandomState, b: int, canvas,
                    num_domains: int, max_gt: int = 128):
    """A training batch as the loaders give it (numpy): random uint8
    images of `canvas`, 2-8 boxes per image inside the canvas, labels
    1..8, domains in turn."""
    H, W = canvas
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        n = rng.randint(2, 9)
        xy = rng.uniform([0, 0], [W * 0.8, H * 0.8], (n, 2))
        wh = rng.uniform(0.05, 0.3, (n, 2)) * [W, H]
        boxes[i, :n] = np.concatenate([xy, np.minimum(xy + wh, [W, H])], 1)
        labels[i, :n] = rng.randint(1, 9, n)
        valid[i, :n] = True
    return {
        "image": rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8),
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "domain": (np.arange(b) % num_domains).astype(np.int32),
        "image_size": np.tile(np.float32(canvas), (b, 1)),
        "scale_back": np.ones((b, 2), np.float32),
    }


def dense_gt_batch(rng: np.random.RandomState, b: int, canvas,
                   num_domains: int = 3, domains: bool = True,
                   max_gt: int = 128):
    """The JAX measurement scripts' batch (scripts/bench_detail.py,
    scripts/bench_eval.py::make_batch), numpy: 3-29 boxes per image, 20-150
    pixels a side, labels 1..8, random uint8 images, content 600x1200. At
    the 608x1216 canvas it is their batch draw for draw; at another canvas
    every coordinate is scaled to it. `domains`: domains in turn (else all
    0, as the eval script's)."""
    H, W = canvas
    s = np.float32([W / 1216.0, H / 608.0])
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        n = rng.randint(3, 30)
        xy = rng.uniform([0, 0], [1000, 450], (n, 2))
        wh = rng.uniform(20, 150, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + wh], 1) * np.tile(s, 2)
        labels[i, :n] = rng.randint(1, 9, n)
        valid[i, :n] = True
    return {
        "image": rng.randint(0, 255, (b, H, W, 3), np.uint8),
        "boxes": boxes, "labels": labels, "gt_valid": valid,
        "domain": ((np.arange(b) % num_domains) if domains
                   else np.zeros(b)).astype(np.int32),
        "image_size": np.tile(np.float32((600, 1200)) * s[::-1], (b, 1)),
        "scale_back": np.ones((b, 2), np.float32),
    }


def calibrate_frozen_bn(model, images: torch.Tensor) -> None:
    """Set every FrozenBatchNorm's mean/var to the per-channel statistics
    of its own input on `images` (uint8 NHWC on the model's device), in
    network order. Random convolutions under identity batch-norm let
    ResNet-50's activations grow block by block until the first SGD steps
    diverge; a pretrained checkpoint's statistics keep them in range, and
    these stand in for them."""

    def pre_hook(mod, inputs):
        x = inputs[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(pre_hook) for m in model.modules()
               if isinstance(m, FrozenBatchNorm)]
    try:
        with torch.no_grad():
            model.detector.features(model.normalize(images))
    finally:
        for h in handles:
            h.remove()


PAIRS = (1, 2, 3, 4)
REG_WEIGHTS = (0.5, 0.5, 0.5, 0.05, 1e-4)

# The sizes of a run on the card (full width) and of a smoke run on the
# CPU (bench_torch.py and the measurement scripts); on the CPU FRCNN
# samples as the CPU tests do (tests/test_flops.py) and a predict pools 32
# proposals per image (the plain RoIAlign is most of a CPU predict).
SIZES = {
    "cuda": dict(canvas=(608, 1216), batch=8, blocks=(3, 4, 6, 3),
                 dtype=torch.bfloat16),
    "cpu": dict(canvas=(64, 128), batch=2, blocks=(1, 1, 1, 1),
                dtype=torch.float32,
                frcnn=dict(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                           rpn_post_nms_train=256, rpn_post_nms_test=32,
                           rpn_batch_per_image=64, box_batch_per_image=64)),
}


def sized_model(family: str, device, size, **kw):
    """`synthetic_model` at one of SIZES (batch `size["batch"]`, unless
    `kw` says otherwise). -> (model, host batches)."""
    from ..models.faster_rcnn import FRCNNConfig

    config = (FRCNNConfig(**size["frcnn"])
              if family == "FRCNN" and "frcnn" in size else None)
    kw.setdefault("batch", size["batch"])
    return synthetic_model(family, device, canvas=size["canvas"],
                           block_counts=size["blocks"],
                           compute_dtype=size["dtype"], config=config, **kw)


def synthetic_model(family: str, device, *, canvas=(608, 1216), batch=8,
                    num_domains=3, block_counts=(3, 4, 6, 3),
                    compute_dtype=torch.bfloat16, config=None, n_batches=1,
                    seed=0, data_seed=5, calibration_images=None):
    """The family's model from random weights (drawn from `seed`) and
    `n_batches` synthetic host batches (numpy, from
    `RandomState(data_seed)`), FrozenBatchNorm calibrated from the first,
    or from `calibration_images` (uint8 NHWC, numpy) where given: images
    unlike the synthetic ones (photographs) need their own statistics, or
    the first SGD steps diverge. `config` is an FRCNNConfig (FRCNN only).
    -> (model, batches)."""
    from ..models.dg_fcos import DGFCOSModel
    from ..models.dg_frcnn import DGFRCNNModel

    kw = {"config": config} if config is not None else {}
    cls = {"FRCNN": DGFRCNNModel, "FCOS": DGFCOSModel}[family]
    model = cls(num_classes=9, num_domains=num_domains, canvas=canvas,
                compute_dtype=compute_dtype,
                backbone_block_counts=block_counts, device=device, seed=seed,
                **kw)
    rng = np.random.RandomState(data_seed)
    batches = [synthetic_batch(rng, batch, canvas, num_domains)
               for _ in range(n_batches)]
    images = (batches[0]["image"] if calibration_images is None
              else calibration_images)
    calibrate_frozen_bn(model, torch.from_numpy(images).to(model.device))
    return model, batches


class HostBatches:
    """Host batches as a loader of the harness: `epoch()` yields each once
    (a train loader), and so does iterating (an eval loader); `rows`, set
    by a mesh Trainer, keeps a row block of each, as the port's loaders
    do."""

    def __init__(self, batches, dg: bool = False):
        self.batches, self.dg, self.rows = batches, dg, None
        self.batch_size = len(batches[0]["image"])

    def epoch(self):
        lo, hi = self.rows or (0, self.batch_size)
        for b in self.batches:
            yield {k: v[lo:hi] for k, v in b.items()}

    def __iter__(self):
        return self.epoch()


def build_dg_cycle(family: str, device, *, batch=8, n_batches=1, **kw):
    """A DG training cycle from random weights, as the harness runs it:
    `synthetic_model`'s model and batches (on `device`; pairs take them in
    turn), the optimizer state, the fused pair steps (0,k) in the DG
    schedule's order and the eval step. Run it with `run_dg_cycle`; a
    cycle holds `images` images, each pair counting its batch twice as
    `Trainer.train_epoch` does."""
    import types

    from ..models.dg_frcnn import batch_to_torch
    from ..train import steps as S
    from ..train.optim import init_opt_state

    model, host = synthetic_model(family, device, batch=batch,
                                  n_batches=n_batches, **kw)
    batches = [batch_to_torch(b, device) for b in host]
    scheduler = S.ModeScheduler(dg=True)
    pairs = []
    for _ in PAIRS:
        m0, mk = scheduler.next_mode(), scheduler.next_mode()
        if m0 != 0:
            raise RuntimeError("the DG schedule must alternate mode 0 with "
                               "mode k")
        pairs.append(mk)
    opt_config, lr = S.make_optimizer(family)
    return types.SimpleNamespace(
        model=model, batches=batches, batch_size=batch,
        opt_config=opt_config, lr=lr, images=2 * batch * len(pairs),
        opt_state=init_opt_state(dict(model.named_parameters()), opt_config),
        gen=torch.Generator(device=device).manual_seed(0),
        steps={k: S.make_pair_step(model, k, REG_WEIGHTS, opt_config, lr)
               for k in pairs},
        eval_step=S.make_eval_step(model))


def run_dg_cycle(cycle, before_pair=None, after_pair=None,
                 sync_pairs=False):
    """One DG cycle of `build_dg_cycle`: each fused pair (0,k) with its
    sampling draws made just before it. `before_pair(k)` runs before pair
    (0,k) and its result is passed on as `after_pair(k, metrics, state,
    ms)` after it. With `sync_pairs` each pair is timed on the host clock
    from a synchronised start to a synchronised end (`ms`, else None).
    -> {k: the pair's metrics}."""
    from .timing import host_ms

    dev = cycle.batches[0]["image"].device
    g = cycle.batches[0]["boxes"].shape[1]
    out = {}
    for i, (k, step) in enumerate(cycle.steps.items()):
        batch = cycle.batches[i % len(cycle.batches)]
        state = before_pair(k) if before_pair else None
        d0 = cycle.model.make_draws(cycle.batch_size, g, cycle.gen,
                                    with_rpn=True)
        dk = cycle.model.make_draws(cycle.batch_size, g, cycle.gen,
                                    with_rpn=False)

        def pair():
            return step(cycle.opt_state, batch, d0, dk)

        if sync_pairs:
            (cycle.opt_state, metrics), ms = host_ms(pair, dev)
        else:
            (cycle.opt_state, metrics), ms = pair(), None
        out[k] = metrics
        if after_pair:
            after_pair(k, metrics, state, ms)
    return out


# -- a dataset on disk: photograph-like PNGs and the reference CSV ---------


def png_filtered(img: np.ndarray, kinds=(0, 1, 2, 3, 4)) -> bytes:
    """RGB or RGBA uint8 [H, W, C] -> PNG bytes whose row y uses filter
    kinds[y % len(kinds)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), each
    row filtered at once in numpy from the source bytes, as libpng does;
    the chunks are data/png.py's."""
    from ..data import png

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    a = np.zeros_like(x)  # left
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)  # up
    b[1:] = x[:-1]
    ul = np.zeros_like(x)  # up-left
    ul[1:, c:] = x[:-1, :-c]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    kind = np.asarray([kinds[y % len(kinds)] for y in range(h)], np.uint8)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = (x - np.choose(kind[:, None].astype(np.intp), preds)) & 255
    colour = {3: 2, 4: 6}[c]
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))  # fast
            + png._chunk(b"IEND", b""))


def scene(rng: np.random.RandomState, hw):
    """A synthetic RGB road scene: a colour gradient, 2-8 flat boxes and
    +-12 of noise, so the filters and the inflate see a photograph's
    entropy (noise alone, which zlib stores, inflates 2-3x faster than a
    street scene). -> (image, the boxes' [x1, y1, x2, y2] rows)."""
    H, W = hw
    c0, c1 = rng.randint(0, 256, (2, 3))
    t = np.linspace(0.0, 1.0, W, dtype=np.float32)[None, :, None]
    img = np.broadcast_to(c0 * (1 - t) + c1 * t, (H, W, 3)).astype(np.int16)
    img = img + rng.randint(-12, 13, (H, W, 3)).astype(np.int16)
    boxes = []
    for _ in range(rng.randint(2, 9)):
        h, w = rng.randint(H // 20, H // 3), rng.randint(W // 30, W // 4)
        y, x = rng.randint(0, H - h), rng.randint(0, W - w)
        img[y:y + h, x:x + w] = rng.randint(0, 256, 3)
        boxes.append((x, y, x + w, y + h))
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def scene_pngs(n: int, hw, seed: int = 0):
    """The images of `write_png_dataset(root, n, hw, seed)`, made in
    memory: for each, (file name, image, PNG bytes with its rows cycling
    the five filters from a start that moves by one per image, CSV
    BoxesString, CSV LabelsString)."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        img, boxes = scene(rng, hw)
        labels = rng.randint(1, 9, len(boxes))
        yield (f"img_{i:04d}.png", img,
               png_filtered(img, kinds=np.roll((0, 1, 2, 3, 4), i)),
               ";".join(" ".join(str(v) for v in b) for b in boxes),
               ";".join(str(v) for v in labels))


def write_png_dataset(root: str, n: int, hw, seed: int = 0,
                      made=None) -> str:
    """Write `n` photograph-like PNGs of `hw` (`scene_pngs`) and the
    reference CSV schema (image_name, BoxesString, LabelsString) into
    `root`, the port of scripts/bench_e2e.py's `make_dataset_on_disk`.
    Files in `root` are reused only if a stamp says they were made with the
    same parameters; otherwise every PNG there is removed and the set
    written anew. `made`: `list(scene_pngs(n, hw, seed))`, where the caller
    holds it already. -> the CSV's path."""
    os.makedirs(root, exist_ok=True)
    stamp_path = os.path.join(root, ".gen_params.json")
    csv_path = os.path.join(root, "annots.csv")
    stamp = {"n": int(n), "hw": [int(v) for v in hw], "seed": int(seed),
             "writer": "scene_pngs"}
    try:
        with open(stamp_path) as f:
            reuse = json.load(f) == stamp and os.path.exists(csv_path)
    except (OSError, ValueError):
        reuse = False
    if reuse:
        return csv_path
    for name in os.listdir(root):
        if name.endswith(".png") or name in (".gen_params.json",
                                             "annots.csv"):
            os.remove(os.path.join(root, name))
    rows = []
    for name, _, data, box_s, label_s in (made or scene_pngs(n, hw, seed)):
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)
        rows.append(f'{name},"{box_s}","{label_s}"\n')
    with open(csv_path, "w") as f:
        f.write("image_name,BoxesString,LabelsString\n")
        f.writelines(rows)
    with open(stamp_path, "w") as f:  # last: a cut write leaves no stamp
        json.dump(stamp, f)
    return csv_path
