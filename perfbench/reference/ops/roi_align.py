"""Multi-scale RoIAlign (port of dgod_tpu/ops/roi_align.py), batched.

torchvision MultiScaleRoIAlign semantics (7x7, sampling_ratio 2,
aligned=False) over P2..P5:

- level per RoI: floor(4 + log2(sqrt(area)/224 + 1e-6)) clamped to the
  available levels (LevelMapper, canonical scale 224 at level 4);
- 7x7 bins, 2x2 sample points per bin at (i + 0.5)/2 fractions;
- bilinear interpolation with torchvision's border rules: sample points
  outside [-1, size] contribute 0, coordinates clamp at 0 and size-1.

`roi_align` is what the model calls: a CUDA tensor goes to kernels K1/K2
(`cuda_roi_align.RoIAlignFunction`), a CPU tensor to `roi_align_plain`,
the autograd-capable gather formulation written here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

STRIDES = (4, 8, 16, 32)
OUTPUT_SIZE = 7
SAMPLING_RATIO = 2


def level_assignment(rois: torch.Tensor, strides: Sequence[int] = STRIDES,
                     canonical_scale: float = 224.0,
                     canonical_level: int = 4) -> torch.Tensor:
    """LevelMapper: rois [..., 4] -> level index [...] int64 in
    [0, len(strides))."""
    area = ((rois[..., 2] - rois[..., 0])
            * (rois[..., 3] - rois[..., 1])).clamp(min=0.0)
    k = torch.floor(canonical_level + torch.log2(
        torch.sqrt(area) / _const(canonical_scale, area) + 1e-6))
    k_min = int(np.round(np.log2(strides[0])))
    return (k - k_min).clamp(0, len(strides) - 1).long()


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor on `like`'s device. Dividing by it is an IEEE
    division everywhere; dividing a CUDA tensor by a Python number is a
    multiplication by its rounded reciprocal, which would move samples off
    the kernel's (and the JAX package's) coordinates."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _bilinear_params(coord: torch.Tensor, size: torch.Tensor):
    """torchvision roi_align bilinear weights along one axis; `size` is an
    int tensor broadcastable to coord. -> (lo, hi, w_lo, w_hi, in_range)."""
    out_of_range = (coord < -1.0) | (coord > size.to(coord.dtype))
    c = coord.clamp(min=0.0)
    lo = torch.floor(c).long()
    at_edge = lo >= size - 1
    lo = torch.minimum(lo, size - 1)
    hi = torch.minimum(lo + 1, size - 1)
    frac = torch.where(at_edge, torch.zeros_like(c), c - lo.to(c.dtype))
    return lo, hi, 1.0 - frac, frac, ~out_of_range


def roi_align_plain(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                    strides: Sequence[int] = STRIDES) -> torch.Tensor:
    """feats: per level [B, H_l, W_l, C] (finest first); rois [B, N, 4]
    xyxy image pixels -> pooled [B, N, 7, 7, C] float32.

    All levels of all images are flattened into one [B*sum(HW), C] table,
    so one gather per bilinear corner serves every RoI at its level.
    Differentiable in the features (the RoIs get no gradient)."""
    P, S = OUTPUT_SIZE, SAMPLING_RATIO
    PS = P * S
    B, N = rois.shape[:2]
    C = feats[0].shape[-1]
    dev = rois.device
    hs = torch.tensor([f.shape[1] for f in feats], device=dev)
    ws = torch.tensor([f.shape[2] for f in feats], device=dev)
    counts = [f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor(np.cumsum([0] + counts[:-1]), device=dev)
    total = sum(counts)
    table = torch.cat([f.reshape(B, -1, C) for f in feats], dim=1)
    table = table.reshape(B * total, C)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)

    rois = rois.reshape(B * N, 4).float()
    lvl = level_assignment(rois, strides)
    scale = scales[lvl]
    h_l, w_l = hs[lvl], ws[lvl]
    base = (torch.arange(B, device=dev).repeat_interleave(N) * total
            + offsets[lvl])

    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    x2 = rois[:, 2] * scale
    y2 = rois[:, 3] * scale
    bin_w = torch.clamp(x2 - x1, min=1.0) / _const(P, x1)
    bin_h = torch.clamp(y2 - y1, min=1.0) / _const(P, y1)
    ar = torch.arange(PS, dtype=torch.float32, device=dev)
    steps = torch.div(ar, S, rounding_mode="floor") + (ar % S + 0.5) / S
    ys = y1[:, None] + steps[None, :] * bin_h[:, None]  # [n, PS]
    xs = x1[:, None] + steps[None, :] * bin_w[:, None]
    y_lo, y_hi, wy_lo, wy_hi, y_ok = _bilinear_params(ys, h_l[:, None])
    x_lo, x_hi, wx_lo, wx_hi, x_ok = _bilinear_params(xs, w_l[:, None])
    ok = (y_ok[:, :, None] & x_ok[:, None, :]).float()  # [n, PS, PS]

    acc = 0.0
    for yi, wy in ((y_lo, wy_lo), (y_hi, wy_hi)):
        for xi, wx in ((x_lo, wx_lo), (x_hi, wx_hi)):
            idx = (base[:, None, None] + yi[:, :, None] * w_l[:, None, None]
                   + xi[:, None, :])  # [n, PS, PS]
            vals = table.index_select(0, idx.reshape(-1)).float()
            w = (wy[:, :, None] * wx[:, None, :] * ok).reshape(-1, 1)
            acc = acc + vals * w
    acc = acc.reshape(B * N, P, S, P, S, C)
    pooled = acc.sum(dim=(2, 4)) * (1.0 / (S * S))
    return pooled.reshape(B, N, P, P, C)


def roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              strides: Sequence[int] = STRIDES) -> torch.Tensor:
    """Multi-scale RoIAlign: kernels K1/K2 for CUDA tensors, the plain
    version for CPU tensors. Same arguments and result as
    `roi_align_plain`."""
    return roi_align_plain(feats, rois, strides)
