"""ResNet-50 + FPN assemblies for each detector (port of
dgod_tpu/models/backbone.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from .fpn import FPN, LastLevelP6P7, last_level_max_pool
from .resnet import ResNet50


class FRCNNBackbone(nn.Module):
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


class FCOSBackbone(nn.Module):
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
