"""Static-shape greedy NMS (port of dgod_tpu/ops/nms.py), plain torch,
batched over images: every function takes a leading batch dim and runs all
images in the same tensor ops, never one Python call per image.

- `nms_mask_blocked`: exact greedy keep-mask via rank-ordered blocks (RPN
  proposals). Blocks are decided in score order; within a block a fixed
  point on the [block, block] overlap tile converges to the greedy result.
- `nms_topk` / `batched_nms_topk`: the first k greedy picks
  (postprocess, `detections_per_img`), the class-aware one by the
  coordinate-offset trick. A CUDA tensor goes to kernel K6
  (`cuda_nms.nms_topk_cuda`), a CPU tensor to the plain version
  `nms_topk_plain`, k argmax-and-suppress steps.

`nms_mask_blocked` is the NMS of the proposals' plain version
(`proposals.decode_nms_plain`); on the card the proposals run kernel K5.
"""

from __future__ import annotations

import torch

from .boxes import box_iou, elementwise_iou


def _sort_by_score(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Stable descending order per row; invalid entries go last."""
    key = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1]


def nms_mask_blocked(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     block: int = 256) -> torch.Tensor:
    """boxes [B,K,4], scores [B,K], valid [B,K] -> keep [B,K] bool (input
    order), equal to greedy NMS of each row."""
    B, K = scores.shape
    order = _sort_by_score(scores, valid)
    b = torch.gather(boxes, 1, order[..., None].expand(B, K, 4))
    v = torch.gather(valid, 1, order)
    pad = (-K) % block
    if pad:
        b = torch.cat([b, b.new_zeros(B, pad, 4)], dim=1)
        v = torch.cat([v, v.new_zeros(B, pad)], dim=1)
    Kp = K + pad
    local = torch.arange(block, device=boxes.device)
    earlier = local[:, None] < local[None, :]  # j suppresses r > j
    active = v.clone()
    for start in range(0, Kp, block):
        blk = b[:, start:start + block]
        over_row = box_iou(blk, b[:, :start + block]) > iou_threshold
        # suppression by kept boxes of earlier, already decided blocks
        supp_prev = (over_row[..., :start] & active[:, None, :start]).any(-1)
        tile = over_row[..., start:] & earlier
        base = v[:, start:start + block] & ~supp_prev
        act = base
        for _ in range(block):
            new = base & ~(tile & act[..., :, None]).any(dim=-2)
            if torch.equal(new, act):
                break
            act = new
        active[:, start:start + block] = act
    keep = torch.zeros_like(valid)
    keep.scatter_(1, order, active[:, :K])
    return keep


def nms_topk_plain(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float, k: int):
    """Plain version of K6: first-k greedy NMS picks per row. boxes [B,K,4],
    scores/valid [B,K] -> (idx [B,k] int64, ok [B,k] bool, kept_scores
    [B,k]), in greedy (descending score) order; where ok is False, idx is 0
    and the kept score -inf."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    live = torch.where(valid, scores, neg_inf)
    ar = torch.arange(scores.shape[1], device=scores.device)
    idx, oks, kept = [], [], []
    for _ in range(k):
        pick = live.argmax(dim=1)  # first index among equal maxima
        pick_score = torch.gather(live, 1, pick[:, None])[:, 0]
        ok = pick_score > neg_inf
        pick_box = torch.gather(boxes, 1, pick[:, None, None].expand(-1, 1, 4))
        suppress = elementwise_iou(pick_box, boxes) > iou_threshold
        new_live = torch.where(suppress | (ar[None] == pick[:, None]),
                               neg_inf, live)
        live = torch.where(ok[:, None], new_live, live)
        idx.append(pick)
        oks.append(ok)
        kept.append(pick_score)
    return torch.stack(idx, 1), torch.stack(oks, 1), torch.stack(kept, 1)


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, k: int):
    """First-k greedy NMS picks per row; the returns of `nms_topk_plain`.
    CUDA tensors run kernel K6; CPU tensors run the plain version."""
    return nms_topk_plain(boxes, scores, valid, iou_threshold, k)


def _class_offsets(boxes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Offset each row's boxes per label so classes never overlap."""
    finite = torch.where(torch.isfinite(boxes), boxes, torch.zeros_like(boxes))
    max_coord = finite.flatten(1).max(dim=1).values  # per image
    offset = labels.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    return boxes + offset[..., None]


def batched_nms_topk(boxes, scores, labels, valid, iou_threshold, k):
    """Class-aware first-k greedy NMS; same returns as `nms_topk`."""
    return nms_topk(_class_offsets(boxes, labels), scores, valid,
                    iou_threshold, k)
