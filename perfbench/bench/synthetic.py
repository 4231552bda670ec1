"""The benchmark's input generators: frozen copies of the generators in
dgod_tpu_torch/utils/synthetic.py and of the PNG chunk writer of
dgod_tpu_torch/data/png.py, held to them by
perfbench/tests/test_perfbench_frozen.py. A traffic mix names its
generator by the function's name (`GENERATORS`)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..reference.models.resnet import FrozenBatchNorm

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


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


def png_filtered(img: np.ndarray, kinds=(0, 1, 2, 3, 4)) -> bytes:
    """RGB or RGBA uint8 [H, W, C] -> PNG bytes whose row y uses filter
    kinds[y % len(kinds)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), each
    row filtered at once in numpy from the source bytes, as libpng does;
    the chunks are data/png.py's."""
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
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                              0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))  # fast
            + _chunk(b"IEND", b""))


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


GENERATORS = {"synthetic_batch": synthetic_batch,
              "dense_gt_batch": dense_gt_batch}
