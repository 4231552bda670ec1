"""FCOS detector (port of dgod_tpu/models/fcos.py), batched over images,
static shapes.

- heads run on all five levels P3..P7, outputs flattened level by level in
  (y, x) row-major location order and concatenated once: [B, R, ...];
- the centre-sampling matcher (kernel K4 on the card) gives each location a
  gt or none; the losses (focal, GIoU, centreness BCE) are summed over the
  batch with masks and divided by the batch's foreground count;
- postprocess: score sqrt(sigmoid(cls) * sigmoid(ctr)) > 0.2, top 1000 per
  level, linear decode, clip, class-aware first-k NMS 0.6 (kernel K6 on the
  card), top 100.

`FCOS.forward` returns, beside the head outputs, an `aux` dict with C5 and
the flattened head-input features (`ins_feat`) that the DG modes consume.
Layouts at the public functions are the JAX package's: C5 NHWC, boxes xyxy,
padded GT [B,G] with validity masks.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_ops
from ..ops import boxes as box_ops
from ..ops import losses as loss_ops
from ..ops import matchers
from ..ops import nms as nms_ops
from ..utils.logging import span
from .backbone import FCOSBackbone
from .faster_rcnn import _gather_rows, _top_sorted
from .layers import Conv, GroupNorm, init_normal

STRIDES = (8, 16, 32, 64, 128)


class FCOSHead(nn.Module):
    """Shared classification and regression towers over all levels: 4 x
    (3x3 conv, GroupNorm(32, eps 1e-5), relu) each in `dtype`, then float32
    prediction convs (class logits with the prior bias, box regression
    through a relu, centreness)."""

    def __init__(self, num_classes: int, num_convs: int = 4,
                 prior_probability: float = 0.01, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.num_convs = num_convs
        self.prior_probability = prior_probability
        for tower in ("cls", "reg"):
            for i in range(num_convs):
                self.add_module(f"{tower}_conv{i}",
                                Conv(256, 256, 3, padding=1, dtype=dtype))
                self.add_module(f"{tower}_gn{i}",
                                GroupNorm(256, 32, eps=1e-5, dtype=dtype))
        self.cls_logits = Conv(256, num_classes, 3, padding=1)
        self.bbox_reg = Conv(256, 4, 3, padding=1)
        self.bbox_ctrness = Conv(256, 1, 3, padding=1)

    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, Conv):
                init_normal(m.weight, 0.01, gen)
        p = self.prior_probability
        with torch.no_grad():
            self.cls_logits.bias.fill_(-math.log((1 - p) / p))

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            conv = getattr(self, f"{name}_conv{i}")
            x = F.relu(getattr(self, f"{name}_gn{i}")(conv(x)))
        return x.float()

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats NCHW -> (cls_logits [B,R,C], bbox_regression [B,R,4],
        bbox_ctrness [B,R,1]), float32, locations in (y, x) order."""
        def flat(t):
            return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])

        all_cls, all_reg, all_ctr = [], [], []
        for f in feats:
            all_cls.append(flat(self.cls_logits(self._tower("cls", f))))
            r = self._tower("reg", f)
            all_reg.append(flat(F.relu(self.bbox_reg(r))))
            all_ctr.append(flat(self.bbox_ctrness(r)))
        return (torch.cat(all_cls, 1), torch.cat(all_reg, 1),
                torch.cat(all_ctr, 1))


def fcos_anchors_for(image_shape: Tuple[int, int]) -> Tuple[np.ndarray, tuple]:
    """Static anchors of a padded canvas -> (anchors [R,4], level counts)."""
    shapes = anchor_ops.fpn_feat_shapes(image_shape, STRIDES)
    anchors, counts = anchor_ops.fcos_anchors(shapes, image_shape)
    return anchors, tuple(counts)


class FCOS(nn.Module):
    """Backbone + head over a static canvas; holds the canvas's anchors."""

    def __init__(self, num_classes: int = 9, canvas=(608, 1216),
                 dtype=torch.float32, backbone_block_counts=(3, 4, 6, 3)):
        super().__init__()
        self.num_classes = num_classes
        self.canvas = tuple(canvas)
        self.backbone = FCOSBackbone(dtype=dtype,
                                     block_counts=tuple(backbone_block_counts))
        self.head = FCOSHead(num_classes, dtype=dtype)
        anchors, counts = fcos_anchors_for(self.canvas)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)  # [R, 4]
        self.anchor_counts = counts

    def reset_parameters(self, gen: torch.Generator):
        self.backbone.reset_parameters(gen)
        self.head.reset_parameters(gen)

    def features(self, images: torch.Tensor):
        """images [B,H,W,3] float -> ([P3..P7] NHWC, C-levels NCHW). The
        convolutions run NCHW in channels_last memory."""
        feats, c = self.backbone(images.permute(0, 3, 1, 2))
        return [f.permute(0, 2, 3, 1) for f in feats], c

    def forward(self, images: torch.Tensor):
        """images [B,H,W,3] float -> (outputs, aux): outputs 'cls_logits'
        [B,R,C], 'bbox_regression' [B,R,4], 'bbox_ctrness' [B,R,1]; aux 'c5'
        [B,h,w,2048] NHWC and 'ins_feat' [B,R,256], the head's input per
        location, both in the compute dtype."""
        with span("dgod.backbone"):
            feats, c = self.features(images)
        with span("dgod.head"):
            cls_logits, bbox_reg, ctrness = self.head(
                [f.permute(0, 3, 1, 2) for f in feats])
            ins_feat = torch.cat([f.reshape(f.shape[0], -1, f.shape[-1])
                                  for f in feats], 1)
        aux = {"c5": c["c5"].permute(0, 2, 3, 1), "ins_feat": ins_feat}
        return {"cls_logits": cls_logits, "bbox_regression": bbox_reg,
                "bbox_ctrness": ctrness}, aux


class FCOSLossConfig(NamedTuple):
    center_sampling_radius: float = 1.5
    # the reference's area formula (y1 - x1) * (y2 - y1) in the matcher
    exact_reference_area: bool = False
    # the reference's `len(labels) <= 1 -> background targets` branch
    single_gt_quirk: bool = False


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """jax.nn.one_hot: a label outside [0, num_classes) gives zeros."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(dtype)


def fcos_match_codes(anchors: torch.Tensor, num_anchors_per_level: tuple,
                     gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                     config: FCOSLossConfig = FCOSLossConfig()) -> torch.Tensor:
    """The matcher's raw codes [B, R] int64 (kernel K4 on the card)."""
    return matchers.fcos_match_batched(
        anchors, gt_boxes.float().contiguous(), gt_valid.contiguous(),
        num_anchors_per_level, config.center_sampling_radius,
        config.exact_reference_area).long()


def fcos_loss(outputs: Dict[str, torch.Tensor], anchors: torch.Tensor,
              num_anchors_per_level: tuple, gt_boxes: torch.Tensor,
              gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              config: FCOSLossConfig = FCOSLossConfig(), matched=None,
              fg_count=None):
    """Batched FCOS loss -> (loss dict, dense one-hot gt_classes [B,R,C]).
    Each loss is summed over the batch and divided by the batch's number of
    foreground locations (at least 1). `matched`: the raw codes of
    `fcos_match_codes` on these gt, where the caller has them; `fg_count`:
    the foreground count to divide by in place of this batch's own (the
    count over the data group when this batch is one rank's rows of a
    global batch)."""
    cls_logits = outputs["cls_logits"]
    bbox_regression = outputs["bbox_regression"]
    bbox_ctrness = outputs["bbox_ctrness"]
    B, R, C = cls_logits.shape

    if matched is None:
        matched = fcos_match_codes(anchors, num_anchors_per_level, gt_boxes,
                                   gt_valid, config)  # [B, R]
    if config.single_gt_quirk:
        # reference: images with <= 1 labels take zero targets everywhere
        few = gt_valid.sum(1) <= 1
        matched = torch.where(few[:, None], (matched >= 0).long() - 1,
                              matched)
        use_zero = few
    else:
        use_zero = torch.zeros(B, dtype=torch.bool, device=matched.device)

    fg = matched >= 0
    safe = matched.clamp(min=0)
    zero = torch.zeros((), device=cls_logits.device)
    gt_boxes_t = torch.where(use_zero[:, None, None], zero,
                             _gather_rows(gt_boxes.float(), safe))
    labels_t = torch.where(use_zero[:, None], 0,
                           torch.gather(gt_labels.long(), 1, safe))
    denom = (fg.float().sum() if fg_count is None
             else fg_count.float()).clamp(min=1.0)

    gt_classes = (one_hot(labels_t, C, cls_logits.dtype)
                  * fg[..., None].to(cls_logits.dtype))
    loss_cls = loss_ops.sigmoid_focal_loss(cls_logits, gt_classes).sum()

    pred_boxes = box_ops.linear_decode(bbox_regression, anchors[None])
    loss_reg = loss_ops.masked_sum(loss_ops.giou_loss(pred_boxes, gt_boxes_t),
                                   fg)

    reg_targets = box_ops.linear_encode(anchors[None], gt_boxes_t)
    lr = reg_targets[..., [0, 2]]
    tb = reg_targets[..., [1, 3]]
    ratio = ((lr.min(-1).values / lr.max(-1).values.clamp(min=1e-12))
             * (tb.min(-1).values / tb.max(-1).values.clamp(min=1e-12)))
    ctr_targets = ratio.clamp(min=0.0).sqrt()
    bce = loss_ops.bce_with_logits(bbox_ctrness[..., 0], ctr_targets)
    loss_ctr = loss_ops.masked_sum(bce, fg)

    losses = {"classification": loss_cls / denom,
              "bbox_regression": loss_reg / denom,
              "bbox_ctrness": loss_ctr / denom}
    return losses, gt_classes


@torch.no_grad()
def fcos_postprocess(outputs: Dict[str, torch.Tensor], anchors: torch.Tensor,
                     num_anchors_per_level: tuple, image_sizes: torch.Tensor,
                     scale_factors: torch.Tensor, score_thresh: float = 0.2,
                     nms_thresh: float = 0.6, detections_per_img: int = 100,
                     topk_candidates: int = 1000):
    """Static-shape detection decoding -> dict of padded detections: boxes
    [B,D,4] (original image frame), scores [B,D], labels [B,D], valid
    [B,D]. image_sizes [B,2] (h, w); scale_factors [B,2] (sy, sx)."""
    cls_logits = outputs["cls_logits"]
    bbox_regression = outputs["bbox_regression"]
    bbox_ctrness = outputs["bbox_ctrness"]
    B, R, C = cls_logits.shape
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    neg_inf = torch.full((), float("-inf"), device=cls_logits.device)
    zero = torch.zeros((), device=cls_logits.device)
    level_boxes, level_scores, level_labels, level_valid = [], [], [], []
    start = 0
    for count in num_anchors_per_level:
        sl = slice(start, start + count)
        start += count
        scores = torch.sqrt(torch.sigmoid(cls_logits[:, sl])
                            * torch.sigmoid(bbox_ctrness[:, sl])).reshape(B, -1)
        masked = torch.where(scores > score_thresh, scores, neg_inf)
        top_scores, top_idx = _top_sorted(masked, min(topk_candidates,
                                                      count * C))
        valid = top_scores > neg_inf
        anchor_idx = top_idx // C
        boxes = box_ops.linear_decode(
            _gather_rows(bbox_regression[:, sl], anchor_idx),
            anchors[sl][anchor_idx])
        level_boxes.append(box_ops.clip_boxes(boxes, h, w))
        level_scores.append(torch.where(valid, top_scores, zero))
        level_labels.append(top_idx % C)
        level_valid.append(valid)

    boxes = torch.cat(level_boxes, 1)
    scores = torch.cat(level_scores, 1)
    labels = torch.cat(level_labels, 1)
    valid = torch.cat(level_valid, 1)
    idx, ok, _ = nms_ops.batched_nms_topk(boxes, scores, labels, valid,
                                          nms_thresh, detections_per_img)
    scale = scale_factors.float().flip(-1).repeat(1, 2)  # (sx, sy, sx, sy)
    out_boxes = _gather_rows(boxes, idx) * scale[:, None, :]
    return {
        "boxes": torch.where(ok[..., None], out_boxes, zero),
        "scores": torch.where(ok, torch.gather(scores, 1, idx), zero),
        "labels": torch.where(ok, torch.gather(labels, 1, idx),
                              torch.zeros_like(idx)),
        "valid": ok,
    }
