"""Host-side image/box transforms producing fixed-shape batches (the port's
own copy of dgod_tpu/data/transforms.py).

Fuses the reference's two transform stages into one host pass per image:
1. albumentations stage (train: Resize(600,1200) + HFlip(0.5) + min_area=20
   box filter, train_driving_dg.py:125-133; val: model-dependent,
   :136-142),
2. the detector-internal GeneralizedRCNNTransform (aspect-preserving
   min/max-size resize + pad-to-32, fasterrcnn.py:441,468 / fcos.py:483)

The output canvas is static (`CANVAS = (608, 1216)` = 600x1200 padded to a
multiple of 32, identical to what the reference detectors see), so every
batch has the same shapes. Images stay uint8 on the host; normalisation
runs on the device (see models; FCOS uses ImageNet stats per
fcos.py:480-482, FRCNN identity per fasterrcnn.py:439-440). The module
globals below are read at call time: tests patch them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

CANVAS: Tuple[int, int] = (608, 1216)
TRAIN_SIZE: Tuple[int, int] = (600, 1200)
MIN_SIZE = 600
MAX_SIZE = 1200
MAX_GT = 128
MIN_AREA = 20.0


class Example(NamedTuple):
    image: np.ndarray  # [CH, CW, 3] uint8 canvas
    boxes: np.ndarray  # [MAX_GT, 4] float32, canvas frame
    labels: np.ndarray  # [MAX_GT] int32
    gt_valid: np.ndarray  # [MAX_GT] bool
    domain: np.int32
    image_size: np.ndarray  # [2] float32 (h, w) of resized content
    scale_back: np.ndarray  # [2] float32 (sy, sx): resized -> original


def _resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize: OpenCV's where cv2 imports, the C++ prep's
    otherwise (native.prepare_image)."""
    from . import native

    return native.prepare_image(img, out_hw, out_hw, False)


def _pad_annotations(boxes: np.ndarray, labels: np.ndarray, max_gt: int = MAX_GT):
    n = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, 4), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    out_b[:n] = boxes[:n]
    out_l[:n] = labels[:n]
    valid[:n] = True
    return out_b, out_l, valid


def _place_on_canvas(img: np.ndarray, canvas_hw=None) -> np.ndarray:
    canvas_hw = canvas_hw or CANVAS  # late-bound: tests patch the module global
    out = np.zeros((canvas_hw[0], canvas_hw[1], 3), img.dtype)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def _min_area_filter(boxes, labels, min_area=None):
    min_area = MIN_AREA if min_area is None else min_area  # late-bound like
    # CANVAS above, so tests patching the module global actually take effect
    if len(boxes) == 0:
        return boxes, labels
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    keep = areas >= min_area
    return boxes[keep], labels[keep]


def train_example(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    domain: int,
    rng: np.random.RandomState,
    max_gt: int = MAX_GT,
) -> Example:
    """Train-time transform: Resize(600x1200) + HFlip(0.5) + min-area filter.

    The image path (resize+flip+pad) is one fused pass
    (native.prepare_image: OpenCV, or the C++ prep without cv2).
    """
    from . import native

    h0, w0 = img.shape[:2]
    th, tw = TRAIN_SIZE
    flip = bool(rng.rand() < 0.5)
    if len(boxes):
        boxes = boxes * np.array([tw / w0, th / h0, tw / w0, th / h0], np.float32)
        if flip:
            boxes = np.stack(
                [tw - boxes[:, 2], boxes[:, 1], tw - boxes[:, 0], boxes[:, 3]], 1
            )
    img = native.prepare_image(img, CANVAS, (th, tw), flip)
    boxes, labels = _min_area_filter(boxes, labels)
    b, l, v = _pad_annotations(boxes, labels, max_gt)
    return Example(
        img, b, l, v, np.int32(domain),
        np.array([th, tw], np.float32),
        np.ones(2, np.float32),
    )


def eval_example(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    domain: int,
    resize_to_train_size: bool,
    max_gt: int = MAX_GT,
) -> Example:
    """Eval transform.

    resize_to_train_size=True mirrors the FCOS val albumentations Resize
    (train_driving_dg.py:140-142); False mirrors FRCNN's raw-size val path
    (:137-138). Either way the detector-internal aspect-preserving
    min600/max1200 rescale then applies; GT boxes stay in the ORIGINAL frame
    (the metric compares against originals, DGcommon.py:154-166) and
    `scale_back` maps predictions back.
    """
    from . import native

    h0, w0 = img.shape[:2]
    resized_first = False
    if resize_to_train_size:
        th, tw = TRAIN_SIZE
        if len(boxes):
            boxes = boxes * np.array([tw / w0, th / h0, tw / w0, th / h0], np.float32)
        h0, w0 = th, tw
        resized_first = True
    # both val pipelines carry bbox_params min_area=20 (train_driving_dg.py:137-142)
    boxes, labels = _min_area_filter(boxes, labels)

    # detector-internal aspect-preserving resize
    scale = min(MIN_SIZE / min(h0, w0), MAX_SIZE / max(h0, w0))
    rh, rw = int(h0 * scale), int(w0 * scale)
    if resized_first and (rh, rw) != (h0, w0):
        # two genuinely different resizes (never at reference geometry:
        # 600x1200 is already within min600/max1200) — stage then fuse
        img = _resize(img, (h0, w0))
    canvas = native.prepare_image(img, CANVAS, (rh, rw), False)
    b, l, v = _pad_annotations(boxes, labels, max_gt)  # original/resized-GT frame
    return Example(
        canvas, b, l, v, np.int32(domain),
        np.array([rh, rw], np.float32),
        np.array([h0 / rh, w0 / rw], np.float32),
    )


def stack_examples(examples) -> dict:
    """Collate Examples into a dict of batched arrays."""
    return {
        "image": np.stack([e.image for e in examples]),
        "boxes": np.stack([e.boxes for e in examples]),
        "labels": np.stack([e.labels for e in examples]),
        "gt_valid": np.stack([e.gt_valid for e in examples]),
        "domain": np.asarray([e.domain for e in examples], np.int32),
        "image_size": np.stack([e.image_size for e in examples]),
        "scale_back": np.stack([e.scale_back for e in examples]),
    }
