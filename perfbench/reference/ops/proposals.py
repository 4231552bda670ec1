"""RPN proposal decode + clip + small-box mask + greedy NMS, all levels and
images in one call (the function of dgod_tpu/ops/pallas_proposals.py).

Inputs are the per-level top-k outputs concatenated along K, in rank order
within each level (scores descending, equal scores lower index first, as
the stable top-k gives them): deltas and anchors [B, K, 4] f32, scores
[B, K], sizes [B, 2] (h, w), and `level_sizes`, the top-k count of each
level (summing to K). Each (image, level) is an independent greedy NMS:
levels never suppress each other.

- `decode_nms_plain`: the plain version, built from `boxes.delta_decode`,
  `clip_boxes`, `small_box_mask` and `nms.nms_mask_blocked` per level.
- `decode_nms`: CUDA tensors go to kernel K5 (`cuda_proposals`), CPU
  tensors to the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import boxes as box_ops
from .nms import nms_mask_blocked


def decode_nms_plain(deltas: torch.Tensor, anchors: torch.Tensor,
                     scores: torch.Tensor, sizes: torch.Tensor,
                     level_sizes: Sequence[int], iou_threshold: float,
                     min_size: float = 1e-3):
    """-> (boxes [B,K,4] f32 decoded and clipped, keep [B,K] bool)."""
    boxes = box_ops.delta_decode(deltas, anchors)
    boxes = box_ops.clip_boxes(boxes, sizes[:, 0:1].float(),
                               sizes[:, 1:2].float())
    ok = box_ops.small_box_mask(boxes, min_size)
    keep = []
    start = 0
    for n in level_sizes:
        end = start + int(n)
        keep.append(nms_mask_blocked(boxes[:, start:end], scores[:, start:end],
                                     ok[:, start:end], iou_threshold))
        start = end
    if start != boxes.shape[1]:
        raise ValueError(f"level_sizes sum to {start}, K is {boxes.shape[1]}")
    return boxes, torch.cat(keep, 1)


def decode_nms(deltas: torch.Tensor, anchors: torch.Tensor,
               scores: torch.Tensor, sizes: torch.Tensor,
               level_sizes: Sequence[int], iou_threshold: float,
               min_size: float = 1e-3):
    """The returns of `decode_nms_plain`. CUDA tensors run kernel K5 (one
    launch, no host sync); CPU tensors run the plain version."""
    return decode_nms_plain(deltas, anchors, scores, sizes, level_sizes,
                            iou_threshold, min_size)
