"""Faster R-CNN (per-image-loss variant), static shapes (port of
dgod_tpu/models/faster_rcnn.py), batched over images throughout.

- RPN head + anchors over P2..P6 (sizes 32..512 x ratios 0.5/1/2); per
  level top-k -> decode -> clip -> small-box filter -> greedy NMS 0.7 (one
  call for all levels, kernel K5 on the card) -> global top post_nms_top_n,
  with validity masks.
- targets: IoU matcher 0.7/0.3 with the low-quality rescue (kernel K3 on
  the card), balanced sampler 256 @ 50%, smooth-L1 (beta 1/9) + BCE.
- RoI head: GT-augmented proposal matching 0.5/0.5, 512 @ 25%, multi-scale
  RoIAlign 7x7 (kernels K1/K2 on the card), TwoMLPHead 12544->1024->1024,
  class + per-class box predictor, CE + smooth-L1/512 losses.
- inference postprocess: softmax, per-class decode (10,10,5,5), clip, drop
  background, score > 0.05, small-box 1e-2, class-aware NMS 0.5, top 100.

Layouts at the public functions are the JAX package's: features NHWC
[B,H,W,C], boxes xyxy, padded GT [B,G] with validity masks, pooled RoI
features [B,N,7,7,C]. Random sampling takes its uniform priorities as
inputs (`pos_u`, `neg_u`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_ops
from ..ops import boxes as box_ops
from ..ops import losses as loss_ops
from ..ops import matchers
from ..ops import nms as nms_ops
from ..ops.proposals import decode_nms
from ..ops.roi_align import roi_align as multiscale_roi_align
from .backbone import frcnn_backbone
from .layers import Conv, Dense, init_lecun_normal, init_normal

STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ASPECT_RATIOS = (0.5, 1.0, 2.0)
A = len(ASPECT_RATIOS)


class FRCNNConfig(NamedTuple):
    num_classes: int = 9  # foreground ids 1..8 + background 0
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_pre_nms_train: int = 2000
    rpn_pre_nms_test: int = 1000
    rpn_post_nms_train: int = 2000
    rpn_post_nms_test: int = 1000
    rpn_nms_thresh: float = 0.7
    box_fg_iou: float = 0.5
    box_bg_iou: float = 0.5
    box_batch_per_image: int = 512
    box_positive_fraction: float = 0.25
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    detections_per_img: int = 100
    box_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / delta 1x1 convs (torchvision RPNHead).
    The convs compute in the model dtype; only the A/4A-channel outputs are
    cast to float32."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(256, 256, 3, padding=1, dtype=dtype)
        self.cls_logits = Conv(256, A, 1, dtype=dtype)
        self.bbox_pred = Conv(256, 4 * A, 1, dtype=dtype)

    def reset_parameters(self, gen):
        for m in (self.conv, self.cls_logits, self.bbox_pred):
            init_normal(m.weight, 0.01, gen)

    def forward(self, feats: Sequence[torch.Tensor]):
        """feats NCHW -> objectness [B, H*W*A], deltas [B, H*W*A, 4] per level
        (anchor order (y, x, a), as the JAX head's NHWC reshape)."""
        objectness, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            B = t.shape[0]
            objectness.append(self.cls_logits(t).float()
                              .permute(0, 2, 3, 1).reshape(B, -1))
            deltas.append(self.bbox_pred(t).float()
                          .permute(0, 2, 3, 1).reshape(B, -1, 4))
        return objectness, deltas


class TwoMLPHead(nn.Module):
    """fc6/fc7 on the pooled RoI patch, flattened HWC as in the JAX model."""

    def __init__(self, in_features: int = 7 * 7 * 256,
                 representation_size: int = 1024, dtype=torch.float32):
        super().__init__()
        self.fc6 = Dense(in_features, representation_size, dtype=dtype)
        self.fc7 = Dense(representation_size, representation_size, dtype=dtype)

    def reset_parameters(self, gen):
        init_lecun_normal(self.fc6.weight, gen)
        init_lecun_normal(self.fc7.weight, gen)

    def forward(self, x):  # [..., 7, 7, C]
        x = x.flatten(-3)
        x = F.relu(self.fc6(x))
        return F.relu(self.fc7(x)).float()


class BoxPredictor(nn.Module):
    """FastRCNNPredictor: class scores (C+1) + per-class box deltas, f32."""

    def __init__(self, num_classes_plus_bg: int, din: int = 1024):
        super().__init__()
        self.cls_score = Dense(din, num_classes_plus_bg)
        self.bbox_pred = Dense(din, num_classes_plus_bg * 4)

    def reset_parameters(self, gen):
        init_normal(self.cls_score.weight, 0.01, gen)
        init_normal(self.bbox_pred.weight, 0.001, gen)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, ...], idx [B, K] -> x[b, idx[b]] [B, K, ...]."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1)
    ex = flat.reshape(flat.shape + (1,) * (x.dim() - 2)).expand(
        flat.shape + x.shape[2:])
    return torch.gather(x, 1, ex).reshape(shape)


def _top_sorted(scores: torch.Tensor, k: int):
    """Per-row top k, descending, lower index first among ties (as
    jax.lax.top_k)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class FRCNNDetector(nn.Module):
    """Faster R-CNN over a static canvas; holds the anchors of the canvas."""

    def __init__(self, config: FRCNNConfig = FRCNNConfig(), canvas=(608, 1216),
                 dtype=torch.float32, backbone_block_counts=(3, 4, 6, 3),
                 backbone: str = "resnet50_fpn", vit=None):
        super().__init__()
        self.config = config
        self.canvas = tuple(canvas)
        self.dtype = dtype
        self.backbone = frcnn_backbone(backbone, self.canvas, dtype,
                                       backbone_block_counts, vit)
        self.rpn_head = RPNHead(dtype=dtype)
        self.box_head = TwoMLPHead(dtype=dtype)
        self.predictor = BoxPredictor(config.num_classes + 1)
        shapes = anchor_ops.fpn_feat_shapes(self.canvas, STRIDES)
        anchors, counts = anchor_ops.rpn_anchors(shapes, self.canvas,
                                                 ANCHOR_SIZES, ASPECT_RATIOS)
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)  # [R, 4]
        self.anchor_counts = tuple(counts)

    def reset_parameters(self, gen: torch.Generator):
        for m in (self.backbone, self.rpn_head, self.box_head, self.predictor):
            m.reset_parameters(gen)

    # -- forward pieces ----------------------------------------------------

    def features(self, images: torch.Tensor, drop_path=None):
        """images [B,H,W,3] float -> ([P2..P5, pool] NHWC, C-levels NCHW).
        The convolutions run NCHW in channels_last memory, so each returned
        level is a contiguous NHWC view on the card. `drop_path`: the
        backbone's drop-path uniforms (ViTDet's, in training), or None."""
        x = images.permute(0, 3, 1, 2)
        feats, c = self.backbone(x, drop_path) \
            if self.backbone.drop_path_depth else self.backbone(x)
        return [f.permute(0, 2, 3, 1) for f in feats], c

    def rpn_forward(self, feats: Sequence[torch.Tensor]):
        return self.rpn_head([f.permute(0, 3, 1, 2) for f in feats])

    @torch.no_grad()
    def generate_proposals(self, objectness, deltas, image_sizes,
                           training: bool):
        """torchvision filter_proposals, static shape. objectness/deltas:
        per-level [B, R_l(, 4)] -> (proposals [B, Npost, 4], valid
        [B, Npost], scores [B, Npost]). No gradient flows through.

        The per-level top-k (a stable sort, as jax.lax.top_k orders ties)
        feeds one `decode_nms` call for every level and image: kernel K5
        on the card, with no host sync."""
        cfg = self.config
        pre_n = cfg.rpn_pre_nms_train if training else cfg.rpn_pre_nms_test
        post_n = cfg.rpn_post_nms_train if training else cfg.rpn_post_nms_test
        top_scores, top_deltas, top_anchors, ks = [], [], [], []
        start = 0
        for lvl, count in enumerate(self.anchor_counts):
            anc = self.anchors[start:start + count]
            start += count
            k = min(pre_n, count)
            s, idx = _top_sorted(objectness[lvl].detach(), k)
            top_scores.append(s)
            top_deltas.append(_gather_rows(deltas[lvl].detach(), idx))
            top_anchors.append(anc[idx])
            ks.append(k)
        top_scores = torch.cat(top_scores, 1)
        boxes, keep = decode_nms(torch.cat(top_deltas, 1),
                                 torch.cat(top_anchors, 1), top_scores,
                                 image_sizes, ks, cfg.rpn_nms_thresh)
        scores = torch.where(keep, top_scores,
                             torch.full_like(top_scores, float("-inf")))
        top_s, top_i = _top_sorted(scores, min(post_n, boxes.shape[1]))
        return (_gather_rows(boxes, top_i),
                torch.gather(keep, 1, top_i) & (top_s > float("-inf")), top_s)

    # -- RPN loss ----------------------------------------------------------

    def rpn_loss(self, objectness, deltas, gt_boxes, gt_valid, pos_u, neg_u):
        """Per-image sampled RPN losses summed over the batch. pos_u/neg_u:
        [B, R] uniform sampling priorities."""
        cfg = self.config
        obj = torch.cat(objectness, 1)  # [B, R]
        dl = torch.cat(deltas, 1)  # [B, R, 4]
        match = matchers.match_anchors_batched(
            gt_boxes.float().contiguous(), gt_valid.contiguous(),
            self.anchors, cfg.rpn_fg_iou, cfg.rpn_bg_iou, True).long()
        fg = match >= 0
        bg = match == matchers.BELOW_LOW
        sample = matchers.balanced_sample(
            fg, bg, cfg.rpn_batch_per_image, cfg.rpn_positive_fraction,
            pos_u, neg_u)
        m_s = torch.gather(match, 1, sample.idx).clamp(min=0)
        reg_targets = box_ops.delta_encode(_gather_rows(gt_boxes.float(), m_s),
                                           self.anchors[sample.idx])
        valid_f = sample.valid.float()
        n_sampled = valid_f.sum(1).clamp(min=1.0)
        box_l = loss_ops.smooth_l1(_gather_rows(dl, sample.idx), reg_targets,
                                   beta=1 / 9).sum(-1)
        box_loss = (box_l * sample.is_pos.float()).sum(1) / n_sampled
        labels = torch.gather(fg, 1, sample.idx).float()
        obj_l = loss_ops.bce_with_logits(torch.gather(obj, 1, sample.idx),
                                         labels)
        obj_loss = (obj_l * valid_f).sum(1) / n_sampled
        return obj_loss.sum(), box_loss.sum()

    # -- RoI sampling ------------------------------------------------------

    @torch.no_grad()
    def select_training_samples(self, proposals, prop_valid, gt_boxes,
                                gt_labels, gt_valid, pos_u, neg_u):
        """torchvision select_training_samples, static shape. pos_u/neg_u:
        [B, Npost + G] priorities. Returns rois [B,S,4], labels [B,S] (0 =
        background), reg_targets [B,S,4], sample_valid [B,S]."""
        cfg = self.config
        gt_boxes = gt_boxes.float()
        all_props = torch.cat([proposals, gt_boxes], 1)
        all_valid = torch.cat([prop_valid, gt_valid], 1)
        iou = box_ops.box_iou(gt_boxes, all_props)  # [B, G, M]
        iou = torch.where(all_valid[:, None, :], iou, torch.zeros_like(iou))
        match = matchers.iou_match(iou, gt_valid, cfg.box_fg_iou,
                                   cfg.box_bg_iou, False).long()
        fg = (match >= 0) & all_valid
        bg = (match == matchers.BELOW_LOW) & all_valid
        mc = match.clamp(min=0)
        labels = torch.where(fg, torch.gather(gt_labels.long(), 1, mc),
                             torch.zeros_like(mc))
        sample = matchers.balanced_sample(
            fg, bg, cfg.box_batch_per_image, cfg.box_positive_fraction,
            pos_u, neg_u)
        rois = _gather_rows(all_props, sample.idx)
        s_labels = torch.gather(labels, 1, sample.idx)
        matched_gt = _gather_rows(gt_boxes, torch.gather(mc, 1, sample.idx))
        reg_t = box_ops.delta_encode(matched_gt, rois, cfg.box_reg_weights)
        return rois, s_labels, reg_t, sample.valid

    # -- box head ----------------------------------------------------------

    def roi_align(self, feats, rois):
        """Multi-scale RoIAlign over P2..P5 -> [B, S, 7, 7, 256] f32."""
        return multiscale_roi_align([f.contiguous() for f in feats[:4]],
                                    rois.contiguous(), STRIDES[:4])

    def box_features(self, feats, rois):
        """RoIAlign + TwoMLPHead -> [B, S, 1024] (the DG hook feature)."""
        return self.box_head(self.roi_align(feats, rois))

    def box_predictions(self, box_feats):
        return self.predictor(box_feats)

    # -- RoI loss ----------------------------------------------------------

    def roi_loss(self, class_logits, box_regression, labels, reg_targets,
                 valid):
        """fastrcnn_loss: per-image CE (mean over valid samples) + smooth-L1
        over positives / S, summed over the batch."""
        B, S = labels.shape
        valid_f = valid.float()
        ce = loss_ops.softmax_cross_entropy(class_logits, labels)
        cls_loss = (ce * valid_f).sum(1) / valid_f.sum(1).clamp(min=1.0)
        box_reg = box_regression.reshape(B, S, -1, 4)
        per_label = torch.gather(
            box_reg, 2, labels[:, :, None, None].expand(B, S, 1, 4))[:, :, 0]
        sl1 = loss_ops.smooth_l1(per_label, reg_targets, beta=1 / 9).sum(-1)
        pos = ((labels > 0) & valid).float()
        box_loss = (sl1 * pos).sum(1) / S
        return cls_loss.sum(), box_loss.sum()

    # -- inference postprocess ---------------------------------------------

    @torch.no_grad()
    def postprocess(self, class_logits, box_regression, proposals, prop_valid,
                    image_sizes, scale_back):
        """RoIHeads.postprocess_detections, static shape, batched."""
        cfg = self.config
        B, N = proposals.shape[:2]
        Cp1 = cfg.num_classes + 1
        scores = torch.softmax(class_logits, -1)
        regs = box_regression.reshape(B, N, Cp1, 4)
        boxes = box_ops.delta_decode(regs, proposals[:, :, None, :],
                                     cfg.box_reg_weights)
        boxes = box_ops.clip_boxes(boxes, image_sizes[:, 0, None, None].float(),
                                   image_sizes[:, 1, None, None].float())
        boxes = boxes[:, :, 1:].reshape(B, -1, 4)
        cls_scores = scores[:, :, 1:].reshape(B, -1)
        labels = torch.arange(1, Cp1, device=boxes.device).repeat(N)
        labels = labels[None].expand(B, -1)
        ok = (prop_valid.repeat_interleave(Cp1 - 1, dim=1)
              & (cls_scores > cfg.box_score_thresh)
              & box_ops.small_box_mask(boxes, 1e-2))
        idx, keep_ok, _ = nms_ops.batched_nms_topk(
            boxes, cls_scores, labels, ok, cfg.box_nms_thresh,
            cfg.detections_per_img)
        scale = scale_back.float().flip(-1).repeat(1, 2)  # (sx, sy, sx, sy)
        out_boxes = _gather_rows(boxes, idx) * scale[:, None, :]
        zero = torch.zeros((), device=boxes.device)
        return {
            "boxes": torch.where(keep_ok[..., None], out_boxes, zero),
            "scores": torch.where(keep_ok, torch.gather(cls_scores, 1, idx),
                                  zero),
            "labels": torch.where(keep_ok, torch.gather(labels, 1, idx),
                                  torch.zeros_like(idx)),
            "valid": keep_ok,
        }
