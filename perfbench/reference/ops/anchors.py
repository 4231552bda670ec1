"""RPN and FCOS anchor grids (the port's own copy of
dgod_tpu/ops/anchors.py).

numpy only, computed once per canvas. Parity: RPN sizes 32..512 x aspect
ratios (0.5, 1, 2) over P2..P6, torchvision cell-anchor rounding, row-major
(y, x) ordering with A anchors per cell (at 608x1216, R = 184,680); FCOS one
unit box per location over P3..P7 (at 608x1216, R = 15,402).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

Shape2D = Tuple[int, int]


def cell_anchors(sizes: Sequence[float],
                 aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred anchors for one level -> [len(sizes)*len(ratios), 4]."""
    scales = np.asarray(sizes, dtype=np.float32)
    ratios = np.asarray(aspect_ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base)


def grid_anchors(feat_shape: Shape2D, stride: Shape2D,
                 cell: np.ndarray) -> np.ndarray:
    """Anchors for one level -> [H*W*A, 4] float32."""
    fh, fw = feat_shape
    sy, sx = stride
    shifts_x = np.arange(fw, dtype=np.float32) * sx
    shifts_y = np.arange(fh, dtype=np.float32) * sy
    sx_grid, sy_grid = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx_grid.ravel(), sy_grid.ravel(),
                       sx_grid.ravel(), sy_grid.ravel()], axis=1)
    anchors = shifts[:, None, :] + cell[None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def rpn_anchors(
    feat_shapes: Sequence[Shape2D],
    image_shape: Shape2D,
    sizes: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,)),
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
) -> Tuple[np.ndarray, List[int]]:
    """All-level RPN anchors -> (anchors [sum(H*W*A), 4], per-level counts)."""
    ih, iw = image_shape
    all_anchors, counts = [], []
    for (fh, fw), level_sizes in zip(feat_shapes, sizes):
        stride = (ih // fh, iw // fw)
        a = grid_anchors((fh, fw), stride,
                         cell_anchors(level_sizes, aspect_ratios))
        all_anchors.append(a)
        counts.append(a.shape[0])
    return np.concatenate(all_anchors, axis=0), counts


def fcos_anchors(
    feat_shapes: Sequence[Shape2D],
    image_shape: Shape2D,
    sizes: Sequence[float] = (8, 16, 32, 64, 128),
) -> Tuple[np.ndarray, List[int]]:
    """FCOS per-location unit anchors over P3..P7: one box of side
    `sizes[level]` per location -> (anchors [sum(H*W), 4], per-level counts).

    The stride is `(ih // fh, iw // fw)`, as in the JAX package: at 608x1216
    that is (60, 64) for P6 and (121, 121) for P7, while the boxes keep the
    sides 64 and 128."""
    return rpn_anchors(feat_shapes, image_shape, [(s,) for s in sizes], (1.0,))


def fpn_feat_shapes(image_shape: Shape2D,
                    strides: Sequence[int]) -> List[Shape2D]:
    """Shapes of a stride-2 conv pyramid: ceil(H / s) per level."""
    ih, iw = image_shape
    return [(int(math.ceil(ih / s)), int(math.ceil(iw / s))) for s in strides]
