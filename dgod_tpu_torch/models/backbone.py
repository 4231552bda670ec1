"""ResNet-50 + FPN assemblies for each detector (port of
dgod_tpu/models/backbone.py), and DG Faster R-CNN's backbone by name
(`frcnn_backbone`): the ResNet-50 FPN by default, or ViTDet-B
(`vitdet.py`)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .fpn import FPN, LastLevelP6P7, last_level_max_pool
from .resnet import ResNet50
from .vitdet import ViTDetBackbone, ViTDetConfig

# DG Faster R-CNN's backbones, the default first
FRCNN_BACKBONES = ("resnet50_fpn", "vitdet_b")


class ResNetTraits:
    """What the code around a backbone reads of it, for the ResNet-50
    FPNs (ViTDetBackbone sets its own): the blocks whose drop-path
    uniforms the draws carry, the optimizer (kind, lr, weight decay) in
    place of the family's, whether tensor parallelism may split the
    detector's heads over the model axis, and whether --torch_weights can
    warm-start it."""
    drop_path_depth = 0
    optimizer = None
    splits_over_model_axis = True
    torchvision_weights = True


class FRCNNBackbone(ResNetTraits, nn.Module):
    """NCHW images -> ([P2, P3, P4, P5, pool], {'c2'..'c5'}), NCHW, strides
    4, 8, 16, 32, 64."""

    def __init__(self, out_channels: int = 256, dtype=torch.float32,
                 block_counts: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.body = ResNet50(dtype=dtype, block_counts=block_counts)
        self.fpn = FPN((256, 512, 1024, 2048), out_channels, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        self.body.reset_parameters(gen)
        self.fpn.reset_parameters(gen)

    def forward(self, x) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        c = self.body(x)
        ps = self.fpn([c["c2"], c["c3"], c["c4"], c["c5"]])
        return ps + [last_level_max_pool(ps[-1])], c


class FCOSBackbone(ResNetTraits, nn.Module):
    """NCHW images -> ([P3, P4, P5, P6, P7], {'c2'..'c5'}), NCHW, strides 8,
    16, 32, 64, 128 (C5 feeds the DG image-level classifier)."""

    def __init__(self, out_channels: int = 256, dtype=torch.float32,
                 block_counts: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.body = ResNet50(dtype=dtype, block_counts=block_counts)
        self.fpn = FPN((512, 1024, 2048), out_channels, dtype=dtype)
        self.p6p7 = LastLevelP6P7(out_channels, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        self.body.reset_parameters(gen)
        self.fpn.reset_parameters(gen)
        self.p6p7.reset_parameters(gen)

    def forward(self, x) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        c = self.body(x)
        ps = self.fpn([c["c3"], c["c4"], c["c5"]])
        return ps + list(self.p6p7(ps[-1])), c


def frcnn_backbone(name: str, canvas: Tuple[int, int], dtype=torch.float32,
                   block_counts: Tuple[int, ...] = (3, 4, 6, 3),
                   vit: Optional[ViTDetConfig] = None) -> nn.Module:
    """DG Faster R-CNN's backbone `name` (FRCNN_BACKBONES): P2-P5 and the
    pool level at 256 channels. `block_counts` sizes the ResNet, `vit` the
    ViTDet (default ViTDet-B)."""
    if name == "resnet50_fpn":
        return FRCNNBackbone(dtype=dtype, block_counts=tuple(block_counts))
    if name == "vitdet_b":
        return ViTDetBackbone(canvas, vit or ViTDetConfig(), dtype=dtype)
    raise ValueError(f"no DG Faster R-CNN backbone {name!r}; "
                     f"choose one of {FRCNN_BACKBONES}")
