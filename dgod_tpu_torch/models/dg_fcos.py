"""DGFCOS — domain-generalised FCOS (port of dgod_tpu/models/dg_fcos.py).

One `nn.Module` holding the detector and the four DG heads, whose parameter
names mirror the JAX parameter tree (`detector.backbone.body...`,
`detector.head.cls_gn0.scale`, `image_da.conv1`, `ins_cls.bank.fc0`, ...).
Five per-mode losses (`loss_for_mode`), `predict`, and the optimizer group
of every parameter (`param_group_labels`). The FCOS losses draw nothing at
random: `make_draws` returns None, so the train steps and the DG cycle of
chip_smoke.py, written for DGFRCNNModel, serve both families.

reg_weights = [w_imgDA, w_insDA, w_consistency, w_clsPrime, w_cls].

Deliberate deviations from the reference, as in the JAX package: the modes
2-4 cross-entropy is taken over the class axis (the reference softmaxes over
the location axis), and mode 1 does not recompute the discarded detection
loss.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import losses as loss_ops
from ..utils.logging import span
from . import dg_heads
from .fcos import (FCOS, FCOSLossConfig, fcos_loss, fcos_match_codes,
                   fcos_postprocess, one_hot)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DGFCOSModel(nn.Module):
    """The DG FCOS. `device=None` means the card (raises without CUDA);
    parameters are float32, drawn from a `torch.Generator` seeded with
    `seed`; the backbone and the head towers compute in `compute_dtype`."""

    name = "FCOS"

    def __init__(self, num_classes: int = 9, num_domains: int = 3,
                 canvas: Tuple[int, int] = (608, 1216),
                 loss_config: FCOSLossConfig = FCOSLossConfig(),
                 compute_dtype=torch.bfloat16,
                 backbone_block_counts=(3, 4, 6, 3), device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.num_domains = num_domains
        self.canvas = tuple(canvas)
        self.loss_config = loss_config
        self.compute_dtype = compute_dtype
        self.detector = FCOS(num_classes, canvas, dtype=compute_dtype,
                             backbone_block_counts=tuple(backbone_block_counts))
        self.image_da = dg_heads.ImageDA(num_domains)
        self.ins_da = dg_heads.fcos_instance_da(num_domains)
        self.ins_cls = dg_heads.DomainBank(
            dg_heads.fcos_ins_cls(num_classes, prime=False), num_domains,
            din=256)
        self.ins_cls_prime = dg_heads.DomainBank(
            dg_heads.fcos_ins_cls(num_classes, prime=True), num_domains,
            din=256)
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
                   generator: torch.Generator, with_rpn: bool = True):
        """FCOS samples nothing: no draws."""
        return None

    # -- forward -----------------------------------------------------------

    @staticmethod
    def normalize(images_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 canvas -> /255, then ImageNet mean/std."""
        x = images_uint8.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        return (x - mean) / std

    def forward(self, images_uint8: torch.Tensor):
        return self.detector(self.normalize(images_uint8))

    def pair_targets(self, batch, batch_sum=None) -> Dict[str, torch.Tensor]:
        """What both halves of a fused pair step take from `batch` alone:
        the matcher's raw codes (modes 0 and 2-4 match the same gt against
        the same anchors, and the match reads no parameter), passed to
        `loss_for_mode` as `matched`. With `batch_sum` (a function that
        sums a count over the ranks whose rows make up the global batch)
        also the global batch's foreground count, `fg_count`, mode 0's
        denominator."""
        det = self.detector
        matched = fcos_match_codes(det.anchors, det.anchor_counts,
                                   batch["boxes"], batch["gt_valid"],
                                   self.loss_config)
        if batch_sum is None:
            return {"matched": matched}
        return {"matched": matched,
                "fg_count": batch_sum((matched >= 0).sum())}

    def _gt_classes(self, batch, matched=None) -> torch.Tensor:
        """Dense one-hot matcher targets [B, R, C]."""
        if matched is None:
            matched = self.pair_targets(batch)["matched"]
        labels = torch.gather(batch["labels"].long(), 1, matched.clamp(min=0))
        return (one_hot(labels, self.num_classes)
                * (matched >= 0)[..., None].float())

    # -- per-mode losses ---------------------------------------------------

    def loss_for_mode(self, batch, draws, mode: int, reg_weights,
                      matched=None, fg_count=None):
        """-> (total loss, metrics dict of detached scalars). `draws` is
        unused (see `make_draws`); `matched`, the raw matcher codes of
        `pair_targets`, is computed here where it is not given; `fg_count`
        (`pair_targets`' global count) replaces the batch's own in mode
        0."""
        if mode == 0:
            outputs, _ = self(batch["image"])
            det = self.detector
            with span("dgod.loss"):
                losses, _ = fcos_loss(outputs, det.anchors,
                                      det.anchor_counts, batch["boxes"],
                                      batch["labels"], batch["gt_valid"],
                                      self.loss_config, matched, fg_count)
                total = (losses["classification"]
                         + losses["bbox_regression"]
                         + losses["bbox_ctrness"])
            return total, {f"det/{k}": v.detach() for k, v in losses.items()}

        _, aux = self(batch["image"])
        with span("dgod.dg_heads"):
            ins_feat = aux["ins_feat"].float()  # [B, R, 256]
            B, R, _ = ins_feat.shape
            domain = batch["domain"].long()
            ce = loss_ops.softmax_cross_entropy

            if mode == 1:
                img_da = self.image_da(aux["c5"])  # [B, D]
                ins_da = self.ins_da(ins_feat)  # [B, R, D]
                l_img = ce(img_da, domain).mean()
                l_ins = ce(ins_da, domain[:, None].expand(B, R)).mean()
                l_cst = ((img_da[:, None, :] - ins_da) ** 2).mean()
                total = (reg_weights[0] * l_img + reg_weights[1] * l_ins
                         + reg_weights[2] * l_cst)
                return total, {"dg/img_da": l_img.detach(),
                               "dg/ins_da": l_ins.detach(),
                               "dg/cst": l_cst.detach()}

            gt_classes = self._gt_classes(batch, matched)  # [B, R, C]
            dense_ce = loss_ops.softmax_cross_entropy_dense

            if mode == 2:
                # detector frozen (torch.no_grad in the reference)
                scores = self.ins_cls(ins_feat.detach(), domain)
                l = dense_ce(scores, gt_classes).mean(1).mean()
                return reg_weights[4] * l, {"dg/ins_cls": l.detach()}

            if mode == 3:
                scores = self.ins_cls_prime(ins_feat, domain)
                l = dense_ce(scores, gt_classes).mean(1).mean()
                return reg_weights[3] * l, {"dg/ins_cls_prime": l.detach()}

            if mode == 4:
                # InsCls frozen: gradients reach only the detector's features
                all_scores = self.ins_cls(ins_feat, mode="all", frozen=True)
                # [D, B]
                ce_img = dense_ce(all_scores, gt_classes[None]).mean(2)
                other = (torch.arange(self.num_domains, device=domain.device)
                         [:, None] != domain[None, :])
                l = loss_ops.masked_mean(ce_img, other)
                return reg_weights[4] * l, {"dg/ins_cls_other": l.detach()}

            raise ValueError(f"unknown mode {mode}")

    # -- inference ---------------------------------------------------------

    @torch.no_grad()
    def predict(self, batch):
        with span("dgod.predict"):
            outputs, _ = self(batch["image"])
            det = self.detector
            with span("dgod.postprocess"):
                return fcos_postprocess(outputs, det.anchors,
                                        det.anchor_counts,
                                        batch["image_size"],
                                        batch["scale_back"])

    # -- optimizer groups --------------------------------------------------

    def param_group_labels(self) -> Dict[str, str]:
        return dg_heads.param_group_labels(self)
