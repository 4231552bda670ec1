"""Target assignment: IoU matcher and balanced fg/bg sampler (port of
dgod_tpu/ops/matchers.py). Static shapes: GT arrives padded `[.., G, 4]`
with a validity mask, outputs are fixed-size index/mask tensors.

- `iou_match`: torchvision Matcher (thresholds, low-quality rescue by value
  equality including ties, BELOW_LOW/BETWEEN codes, empty GT -> all
  BELOW_LOW).
- `match_anchors_batched`: fused box IoU + `iou_match` over a batch. A CUDA
  tensor goes to kernel K3 (`cuda_matchers.iou_match_cuda`), a CPU tensor
  to the plain version `match_anchors_plain`.
- `fcos_match_batched`: the FCOS centre-sampling matcher over a batch. A
  CUDA tensor goes to kernel K4 (`cuda_matchers.fcos_match_cuda`), a CPU
  tensor to the plain version `fcos_match`.
- `balanced_sample`: torchvision BalancedPositiveNegativeSampler as
  fixed-size sampling; the uniform priorities are an input, so the caller
  decides where the randomness comes from (a torch.Generator on the main
  path, the JAX model's own draws in the parity tests).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import box_iou

BELOW_LOW = -1
BETWEEN = -2


def iou_match(iou: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
              low_threshold: float, allow_low_quality_matches: bool
              ) -> torch.Tensor:
    """iou [..., G, R], gt_valid [..., G] -> matches [..., R] int32: gt
    index, BELOW_LOW or BETWEEN."""
    neg_inf = torch.tensor(float("-inf"), dtype=iou.dtype, device=iou.device)
    masked = torch.where(gt_valid[..., :, None], iou, neg_inf)
    # torch.max over a dim returns the first index among equal maxima, as
    # jnp.argmax does
    matched_vals, matches = masked.max(dim=-2)
    matches = matches.to(torch.int32)
    below = torch.full_like(matches, BELOW_LOW)
    between = torch.full_like(matches, BETWEEN)

    out = torch.where(matched_vals < low_threshold, below, matches)
    out = torch.where((matched_vals >= low_threshold)
                      & (matched_vals < high_threshold), between, out)
    if allow_low_quality_matches:
        # predictions tying a gt's best IoU (equality, ties included) are
        # restored to their original argmax match
        best_per_gt = masked.max(dim=-1, keepdim=True).values
        is_best = ((masked == best_per_gt) & gt_valid[..., :, None]
                   & (best_per_gt > neg_inf))
        out = torch.where(is_best.any(dim=-2), matches, out)
    no_gt = ~gt_valid.any(dim=-1, keepdim=True)
    return torch.where(no_gt, below, out)


def match_anchors_plain(gt_boxes, gt_valid, anchors, high_threshold,
                        low_threshold, allow_low_quality_matches):
    """Plain version of K3: gt [B,G,4]/[B,G] x anchors [R,4] -> [B,R] int32.
    Materialises the [B,G,R] IoU planes."""
    iou = box_iou(gt_boxes.float(), anchors.float()[None])
    return iou_match(iou, gt_valid, high_threshold, low_threshold,
                     allow_low_quality_matches)


def match_anchors_batched(gt_boxes, gt_valid, anchors, high_threshold,
                          low_threshold, allow_low_quality_matches):
    """Fused box_iou + `iou_match` over the batch -> matches [B, R] int32.
    CUDA tensors run kernel K3; CPU tensors run the plain version."""
    return match_anchors_plain(gt_boxes, gt_valid, anchors, high_threshold,
                               low_threshold, allow_low_quality_matches)


def fcos_match(anchors: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, num_anchors_per_level,
               center_sampling_radius: float = 1.5,
               exact_reference_area: bool = False) -> torch.Tensor:
    """Plain version of K4, the FCOS centre-sampling matcher over a batch:
    anchors [R,4] unit boxes (all levels), gt [B,G,4]/[B,G] -> matched
    index [B,R] int32 in [-1, G). Materialises [B,R,G] planes.

    An anchor matches a valid gt when its centre lies within radius * size
    of the gt centre (Chebyshev), strictly inside the gt, and its largest
    regression distance inside its level's range; among matches the
    smallest area wins (argmax of mask * (1e8 - area), first index on ties),
    and a best quality below 1e-5 means no match. `exact_reference_area`
    computes the area as (y1 - x1) * (y2 - y1), the reference's formula."""
    # anchor planes [R, 1], as fcos_match_tpu builds them: centre, radius *
    # size, and the range of the largest distance, (4, 8) * size with the
    # first level from 0 and the last to infinity
    anchors = anchors.float()
    R = anchors.shape[0]
    size = (anchors[:, 2] - anchors[:, 0])[:, None]
    cx = 0.5 * (anchors[:, 0:1] + anchors[:, 2:3])
    cy = 0.5 * (anchors[:, 1:2] + anchors[:, 3:4])
    rad = center_sampling_radius * size
    pos = torch.arange(R, device=anchors.device)[:, None]
    lower = torch.where(pos < num_anchors_per_level[0],
                        torch.zeros_like(size), size * 4.0)
    upper = torch.where(pos >= R - num_anchors_per_level[-1],
                        torch.full_like(size, float("inf")), size * 8.0)
    gt = gt_boxes.float()
    gx1, gy1, gx2, gy2 = (gt[:, None, :, i] for i in range(4))  # [B, 1, G]
    gcx = 0.5 * (gx1 + gx2)
    gcy = 0.5 * (gy1 + gy2)
    match = torch.maximum((cx - gcx).abs(), (cy - gcy).abs()) < rad
    d1, d2, d3, d4 = cx - gx1, cy - gy1, gx2 - cx, gy2 - cy  # [B, R, G]
    match &= torch.minimum(torch.minimum(d1, d2), torch.minimum(d3, d4)) > 0
    max_d = torch.maximum(torch.maximum(d1, d2), torch.maximum(d3, d4))
    match &= (max_d > lower) & (max_d < upper)
    match &= gt_valid[:, None, :]
    if exact_reference_area:
        area = (gy1 - gx1) * (gy2 - gy1)
    else:
        area = (gx2 - gx1) * (gy2 - gy1)
    quality = match.float() * (1e8 - area)
    best, idx = quality.max(dim=-1)  # first index among equal maxima
    return torch.where(best < 1e-5, torch.full_like(idx, -1), idx).to(
        torch.int32)


def fcos_match_batched(anchors, gt_boxes, gt_valid, num_anchors_per_level,
                       center_sampling_radius=1.5, exact_reference_area=False):
    """`fcos_match` over the batch -> matched [B, R] int32. CUDA tensors run
    kernel K4; CPU tensors run the plain version."""
    return fcos_match(anchors, gt_boxes, gt_valid, num_anchors_per_level,
                      center_sampling_radius, exact_reference_area)


class SampleResult(NamedTuple):
    idx: torch.Tensor  # [..., num_samples] int64 indices into predictions
    is_pos: torch.Tensor  # [..., num_samples] bool
    valid: torch.Tensor  # [..., num_samples] bool (False for padding)


def _top_indices(priority: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest priorities, lower index first among ties
    (jax.lax.top_k's order; torch.topk promises none)."""
    return torch.sort(priority, dim=-1, descending=True, stable=True)[1][..., :k]


def balanced_sample(pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                    num_samples: int, positive_fraction: float,
                    pos_u: torch.Tensor, neg_u: torch.Tensor) -> SampleResult:
    """Fixed-size balanced positive/negative sampling over the last dim.

    pos_mask/neg_mask [..., R] bool; pos_u/neg_u [..., R] uniform [0, 1)
    priorities. Takes min(#pos, num_samples*positive_fraction) positives in
    priority order, fills the rest with negatives up to availability;
    positives come first and `valid` marks real samples."""
    R = pos_mask.shape[-1]
    max_pos = int(num_samples * positive_fraction)
    neg_inf = torch.tensor(float("-inf"), dtype=pos_u.dtype, device=pos_u.device)
    pos_pri = torch.where(pos_mask, pos_u, neg_inf)
    neg_pri = torch.where(neg_mask, neg_u, neg_inf)

    n_pos = pos_mask.sum(-1, keepdim=True).clamp(max=max_pos)
    n_neg = torch.minimum(neg_mask.sum(-1, keepdim=True), num_samples - n_pos)

    k = min(num_samples, R)
    pos_idx = _top_indices(pos_pri, k)
    neg_idx = _top_indices(neg_pri, k)
    if k < num_samples:
        pad = pos_idx.new_zeros(pos_idx.shape[:-1] + (num_samples - k,))
        pos_idx = torch.cat([pos_idx, pad], dim=-1)
        neg_idx = torch.cat([neg_idx, pad], dim=-1)

    rank = torch.arange(num_samples, device=pos_mask.device)
    take_pos = rank < n_pos
    neg_slot = (rank - n_pos).clamp(0, num_samples - 1)
    idx = torch.where(take_pos, pos_idx, torch.gather(neg_idx, -1, neg_slot))
    valid = rank < (n_pos + n_neg)
    return SampleResult(idx, take_pos & valid, valid)
