"""Box geometry ops (port of dgod_tpu/ops/boxes.py), torch, static shapes.

Boxes are `[..., 4]` xyxy. Padded/invalid boxes are the caller's business
(masks); these functions are total. The arithmetic follows the JAX module
op for op so float32 results agree to rounding.
"""

from __future__ import annotations

import math

import torch

# torchvision BoxCoder's clamp on decoded w/h deltas
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes1 [..., N, 4], boxes2 [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of aligned (broadcastable) box arrays [..., 4] -> [...]."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip xyxy boxes to [0, width] x [0, height]; height/width are scalars
    or tensors broadcastable against boxes[..., 0]."""
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0.0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0.0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0.0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0.0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with both sides >= min_size (remove_small_boxes)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


def delta_encode(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Encode gt `reference_boxes` relative to anchors/proposals."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    one = torch.ones_like(ex_w)
    # guard against degenerate (padded) boxes
    safe_w = torch.where(ex_w > 0, ex_w, one)
    safe_h = torch.where(ex_h > 0, ex_h, one)
    safe_gt_w = torch.where(gt_w > 0, gt_w, one)
    safe_gt_h = torch.where(gt_h > 0, gt_h, one)

    dx = wx * (gt_cx - ex_cx) / safe_w
    dy = wy * (gt_cy - ex_cy) / safe_h
    dw = ww * torch.log(safe_gt_w / safe_w)
    dh = wh * torch.log(safe_gt_h / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def delta_decode(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Decode deltas on top of anchors/proposals `boxes` [..., 4]."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = rel_codes[..., 0] / wx
    dy = rel_codes[..., 1] / wy
    dw = (rel_codes[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (rel_codes[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h

    x1 = pred_cx - 0.5 * pred_w
    y1 = pred_cy - 0.5 * pred_h
    x2 = pred_cx + 0.5 * pred_w
    y2 = pred_cy + 0.5 * pred_h
    return torch.stack([x1, y1, x2, y2], dim=-1)


# -- linear (FCOS) box coder: anchor centre to the four edges, normalised by
#    the anchor's size -------------------------------------------------------

def linear_encode(reference_boxes: torch.Tensor,
                  proposals: torch.Tensor) -> torch.Tensor:
    """Encode target `proposals` around anchor `reference_boxes` -> l/t/r/b
    offsets over the anchor's width/height."""
    ctr_x = 0.5 * (reference_boxes[..., 0] + reference_boxes[..., 2])
    ctr_y = 0.5 * (reference_boxes[..., 1] + reference_boxes[..., 3])
    l = ctr_x - proposals[..., 0]
    t = ctr_y - proposals[..., 1]
    r = proposals[..., 2] - ctr_x
    b = proposals[..., 3] - ctr_y
    out = torch.stack([l, t, r, b], dim=-1)
    w = reference_boxes[..., 2] - reference_boxes[..., 0]
    h = reference_boxes[..., 3] - reference_boxes[..., 1]
    return out / torch.stack([w, h, w, h], dim=-1)


def linear_decode(rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Decode l/t/r/b offsets back to xyxy boxes around anchors `boxes`."""
    ctr_x = 0.5 * (boxes[..., 0] + boxes[..., 2])
    ctr_y = 0.5 * (boxes[..., 1] + boxes[..., 3])
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    rel = rel_codes * torch.stack([w, h, w, h], dim=-1)
    return torch.stack([ctr_x - rel[..., 0], ctr_y - rel[..., 1],
                        ctr_x + rel[..., 2], ctr_y + rel[..., 3]], dim=-1)
