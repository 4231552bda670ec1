"""Detection losses (port of dgod_tpu/ops/losses.py).

Elementwise, mask-aware. `softmax_cross_entropy` and
`softmax_cross_entropy_dense` are applied by the DG heads to their *sigmoid
outputs*, a quirk of the reference kept as it is.
"""

from __future__ import annotations

import torch

from .boxes import box_area


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (no reduction); targets in {0, 1}."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits: max(x,0) - x*t + log1p(exp(-|x|))."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) loss with threshold `beta`."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          dim: int = -1) -> torch.Tensor:
    """CE with integer labels, no reduction (F.cross_entropy per element)."""
    logp = torch.log_softmax(logits, dim=dim)
    return -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)


def softmax_cross_entropy_dense(logits: torch.Tensor, target_probs: torch.Tensor,
                                dim: int = -1) -> torch.Tensor:
    """CE with a dense target distribution along `dim` (the FCOS DG modes'
    one-hot `gt_classes`)."""
    return -(target_probs * torch.log_softmax(logits, dim=dim)).sum(dim)


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - GIoU of xyxy boxes [..., 4].

    The forward is the JAX formula value for value, and the clips are
    `maximum(x, 0)` as `jnp.clip` computes them, so a zero-width box splits
    the gradient at the kink as JAX does. Its two divisions are guarded
    twice (`where` on the denominator as well as on the result): a
    degenerate enclosing box (area_c = 0, e.g. a zero-size prediction against
    a padded all-zero target) then back-propagates 0 instead of the 0 * inf
    = NaN that dgod_tpu's single `where` gives."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(pred) + box_area(target) - inter
    one = torch.ones_like(union)
    iou = inter / torch.where(union > 0, union, one)
    iou = torch.where(union > 0, iou, zero)

    # smallest enclosing box
    lt_c = torch.minimum(pred[..., :2], target[..., :2])
    rb_c = torch.maximum(pred[..., 2:], target[..., 2:])
    wh_c = torch.maximum(rb_c - lt_c, zero)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    pos = area_c > 0
    giou = iou - torch.where(pos, (area_c - union)
                             / torch.where(pos, area_c, one), zero)
    return 1.0 - giou


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where mask is True; 0 if the mask is empty."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp(min=1.0)


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (values * mask.to(values.dtype)).sum()
