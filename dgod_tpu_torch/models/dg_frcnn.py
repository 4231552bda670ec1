"""DGFRCNN — domain-generalised Faster R-CNN (port of
dgod_tpu/models/dg_frcnn.py).

One `nn.Module` holding the detector and the four DG heads, whose parameter
names mirror the JAX parameter tree (`detector.backbone.body...`,
`image_da.conv1`, `ins_cls.bank.fc0`, ...). Five per-mode losses
(`loss_for_mode`), `predict`, and the optimizer group of every parameter
(`param_group_labels`).

reg_weights = [w_imgDA, w_insDA, w_consistency, w_clsPrime, w_cls].

Randomness: the RPN and RoI samplers take uniform priorities from a
`Draws` tuple, made by `make_draws` from a `torch.Generator` (or handed in
by a test, from the JAX model's own keys); so does ViTDet's drop-path.

The backbone is chosen by name (`backbone.FRCNN_BACKBONES`): the ResNet-50
FPN by default, or ViTDet-B (`vitdet.py`), whose pixels are normalised by
the backbone itself and whose drop-path masks come from `Draws.drop_path`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import losses as loss_ops
from ..utils.logging import span
from . import dg_heads
from .faster_rcnn import FRCNNConfig, FRCNNDetector


class Draws(NamedTuple):
    """Uniform [0, 1) sampling priorities for one loss evaluation."""
    rpn_pos: Optional[torch.Tensor]  # [B, R] (mode 0 only)
    rpn_neg: Optional[torch.Tensor]
    roi_pos: torch.Tensor  # [B, Npost + G]
    roi_neg: torch.Tensor
    # [B, depth, 2]: ViTDet's drop-path uniforms (attention, MLP branch)
    drop_path: Optional[torch.Tensor] = None


def batch_to_torch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy/torch batch dict -> tensors on `device` (contiguous)."""
    return {k: torch.as_tensor(v).to(device).contiguous()
            for k, v in batch.items()}


class DGFRCNNModel(nn.Module):
    """The DG Faster R-CNN. `device=None` means the card (raises without
    CUDA); parameters are float32, drawn from `torch.Generator` seeded with
    `seed`; the convolutions, the ViT's linear layers and the box head
    compute in `compute_dtype`. `backbone`: "resnet50_fpn" (sized by
    `backbone_block_counts`) or "vitdet_b" (sized by `vit`, a
    `vitdet.ViTDetConfig`, default ViTDet-B)."""

    name = "FRCNN"

    def __init__(self, num_classes: int = 9, num_domains: int = 3,
                 canvas: Tuple[int, int] = (608, 1216),
                 config: FRCNNConfig = None,
                 compute_dtype=torch.bfloat16,
                 backbone_block_counts=(3, 4, 6, 3), device=None,
                 seed: int = 0, backbone: str = "resnet50_fpn", vit=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.num_domains = num_domains
        self.canvas = tuple(canvas)
        self.compute_dtype = compute_dtype
        self.config = config or FRCNNConfig(num_classes=num_classes)
        self.detector = FRCNNDetector(
            self.config, canvas, dtype=compute_dtype,
            backbone_block_counts=tuple(backbone_block_counts),
            backbone=backbone, vit=vit)
        self.image_da = dg_heads.ImageDAFPN(num_domains)
        self.ins_da = dg_heads.frcnn_instance_da(num_domains)
        self.ins_cls = dg_heads.DomainBank(
            dg_heads.frcnn_ins_cls(num_classes, prime=False), num_domains)
        self.ins_cls_prime = dg_heads.DomainBank(
            dg_heads.frcnn_ins_cls(num_classes, prime=True), num_domains)
        gen = torch.Generator().manual_seed(seed)
        self.detector.reset_parameters(gen)
        for head in (self.image_da, self.ins_da, self.ins_cls,
                     self.ins_cls_prime):
            head.reset_parameters(gen)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.detector.anchors.device

    def make_draws(self, batch_size: int, num_gt: int,
                   generator: torch.Generator, with_rpn: bool = True) -> Draws:
        """Sampling priorities for one loss evaluation on a batch padded to
        `num_gt` boxes; `with_rpn` for mode 0, the only mode with an RPN
        loss; ViTDet's drop-path uniforms last. `generator` lives on the
        model's device."""
        cfg = self.config
        n_prop = min(cfg.rpn_post_nms_train,
                     sum(min(cfg.rpn_pre_nms_train, c)
                         for c in self.detector.anchor_counts))

        def uniform(n):
            return torch.rand((batch_size, n), generator=generator,
                              device=self.device)

        R = self.detector.anchors.shape[0]
        rpn = (uniform(R), uniform(R)) if with_rpn else (None, None)
        roi = (uniform(n_prop + num_gt), uniform(n_prop + num_gt))
        depth = self.detector.backbone.drop_path_depth
        if not depth:
            return Draws(*rpn, *roi)
        drop = torch.rand((batch_size, depth, 2), generator=generator,
                          device=self.device)
        return Draws(*rpn, *roi, drop)

    def pair_targets(self, batch, batch_sum=None) -> Dict[str, torch.Tensor]:
        """Nothing that both halves of a fused pair step share: mode 0's
        RPN match is its own (see DGFCOSModel.pair_targets), and no loss
        divides by a count over the batch, so `batch_sum` goes unused."""
        return {}

    # -- forward -----------------------------------------------------------

    @staticmethod
    def normalize(images_uint8: torch.Tensor) -> torch.Tensor:
        """/255 only (the reference FRCNN's identity transform stats)."""
        return images_uint8.float() / 255.0

    def _train_forward(self, batch, draws: Draws, need_rpn_grad: bool,
                       stop_box_grad: bool = False):
        det = self.detector
        with span("dgod.backbone"):
            feats, _ = det.features(self.normalize(batch["image"]),
                                    draws.drop_path)
        with span("dgod.rpn"):
            with torch.set_grad_enabled(need_rpn_grad
                                        and torch.is_grad_enabled()):
                objectness, deltas = det.rpn_forward(feats)
            proposals, prop_valid, _ = det.generate_proposals(
                objectness, deltas, batch["image_size"], training=True)
        with span("dgod.roi"):
            rois, roi_labels, reg_targets, roi_valid = \
                det.select_training_samples(
                    proposals, prop_valid, batch["boxes"], batch["labels"],
                    batch["gt_valid"], draws.roi_pos, draws.roi_neg)
            f_in = [f.detach() for f in feats] if stop_box_grad else feats
            box_features = det.box_features(f_in, rois)
        return {
            "feats": feats,
            "objectness": objectness,
            "deltas": deltas,
            "rois": rois,
            "roi_labels": roi_labels,
            "reg_targets": reg_targets,
            "roi_valid": roi_valid,
            "box_features": box_features,
        }

    # -- per-mode losses ---------------------------------------------------

    def loss_for_mode(self, batch, draws: Draws, mode: int, reg_weights):
        """-> (total loss, metrics dict of detached scalars)."""
        det = self.detector
        if mode == 0:
            fwd = self._train_forward(batch, draws, need_rpn_grad=True)
            with span("dgod.loss"):
                obj_loss, rpn_box_loss = det.rpn_loss(
                    fwd["objectness"], fwd["deltas"], batch["boxes"],
                    batch["gt_valid"], draws.rpn_pos, draws.rpn_neg)
            with span("dgod.box_head"):
                logits, box_reg = det.box_predictions(fwd["box_features"])
            with span("dgod.loss"):
                cls_loss, box_loss = det.roi_loss(
                    logits, box_reg, fwd["roi_labels"], fwd["reg_targets"],
                    fwd["roi_valid"])
                total = obj_loss + rpn_box_loss + cls_loss + box_loss
            return total, {
                "det/loss_objectness": obj_loss.detach(),
                "det/loss_rpn_box_reg": rpn_box_loss.detach(),
                "det/loss_classifier": cls_loss.detach(),
                "det/loss_box_reg": box_loss.detach(),
            }

        # mode 2 freezes the detector (torch.no_grad in the reference)
        fwd = self._train_forward(batch, draws, need_rpn_grad=False,
                                  stop_box_grad=(mode == 2))
        with span("dgod.dg_heads"):
            box_feats = fwd["box_features"]  # [B, S, 1024]
            B, S, _ = box_feats.shape
            domain = batch["domain"].long()
            ce = loss_ops.softmax_cross_entropy

            if mode == 1:
                img_da = self.image_da(fwd["feats"][0].float())  # [B, D]
                ins_da = self.ins_da(box_feats.reshape(B * S, -1))  # [B*S, D]
                l_img = ce(img_da, domain).mean()
                l_ins = ce(ins_da, domain.repeat_interleave(S)).mean()
                exp_img = img_da.repeat_interleave(S, dim=0)
                l_cst = ((ins_da - exp_img) ** 2).mean()
                total = (reg_weights[0] * l_img + reg_weights[1] * l_ins
                         + reg_weights[2] * l_cst)
                return total, {"dg/img_da": l_img.detach(),
                               "dg/ins_da": l_ins.detach(),
                               "dg/cst": l_cst.detach()}

            roi_labels = fwd["roi_labels"]  # [B, S], 0 = background

            if mode == 2:
                scores = self.ins_cls(box_feats, domain)  # [B, S, C]
                l = ce(scores, roi_labels).mean(1).mean()
                return reg_weights[4] * l, {"dg/ins_cls": l.detach()}

            if mode == 3:
                scores = self.ins_cls_prime(box_feats, domain)
                l = ce(scores, roi_labels).mean(1).mean()
                return reg_weights[3] * l, {"dg/ins_cls_prime": l.detach()}

            if mode == 4:
                all_scores = self.ins_cls(box_feats, mode="all", frozen=True)
                ce_all = ce(all_scores, roi_labels[None].expand(
                    self.num_domains, -1, -1))  # [D, B, S]
                other = (torch.arange(self.num_domains, device=domain.device)
                         [:, None] != domain[None, :])
                l = loss_ops.masked_mean(ce_all.mean(2), other)
                return reg_weights[4] * l, {"dg/ins_cls_other": l.detach()}

            raise ValueError(f"unknown mode {mode}")

    # -- inference ---------------------------------------------------------

    @torch.no_grad()
    def predict(self, batch):
        det = self.detector
        with span("dgod.predict"):
            with span("dgod.backbone"):
                feats, _ = det.features(self.normalize(batch["image"]))
            with span("dgod.rpn"):
                objectness, deltas = det.rpn_forward(feats)
                proposals, prop_valid, _ = det.generate_proposals(
                    objectness, deltas, batch["image_size"], training=False)
            with span("dgod.roi"):
                box_feats = det.box_features(feats, proposals)
            with span("dgod.box_head"):
                logits, box_reg = det.box_predictions(box_feats)
            with span("dgod.postprocess"):
                return det.postprocess(logits, box_reg, proposals,
                                       prop_valid, batch["image_size"],
                                       batch["scale_back"])

    # -- optimizer groups --------------------------------------------------

    def param_group_labels(self) -> Dict[str, str]:
        return dg_heads.param_group_labels(self)
