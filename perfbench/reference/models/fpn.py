"""Feature Pyramid Network (port of dgod_tpu/models/fpn.py): laterals,
nearest-neighbour top-down pathway, 3x3 smoothing convs; LastLevelMaxPool
for Faster R-CNN's 'pool' level (stride 64) and LastLevelP6P7 for FCOS's P6
and P7 (strides 64 and 128).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, init_variance_scaling


def upsample_nearest(x: torch.Tensor, target_hw) -> torch.Tensor:
    """NCHW nearest upsample, index map floor(i * in / out) (exact for the
    2x steps of a canvas divisible by 32); keeps channels_last."""
    return F.interpolate(x, size=tuple(target_hw), mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype=torch.float32):
        super().__init__()
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(cin, out_channels, 1,
                                                dtype=dtype))
        for i in range(len(in_channels)):
            self.add_module(f"output{i}", Conv(out_channels, out_channels, 3,
                                               padding=1, dtype=dtype))
        self.n = len(in_channels)

    def reset_parameters(self, gen: torch.Generator):
        # variance_scaling(1/3, fan_in, uniform), zero bias (as in the JAX FPN)
        for m in self.modules():
            if isinstance(m, Conv):
                init_variance_scaling(m.weight, 1.0 / 3.0, "fan_in",
                                      "uniform", gen)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [getattr(self, f"lateral{i}")(f)
                    for i, f in enumerate(feats)]
        merged = [None] * self.n
        merged[-1] = laterals[-1]
        for i in range(self.n - 2, -1, -1):
            merged[i] = laterals[i] + upsample_nearest(
                merged[i + 1], laterals[i].shape[2:])
        return [getattr(self, f"output{i}")(m) for i, m in enumerate(merged)]


def last_level_max_pool(p_last: torch.Tensor) -> torch.Tensor:
    """Extra 'pool' level: 1x1 max pool with stride 2."""
    return F.max_pool2d(p_last, 1, 2)


class LastLevelP6P7(nn.Module):
    """P6/P7 from P5: 3x3 stride-2 convs with a relu between (FCOS)."""

    def __init__(self, out_channels: int = 256, dtype=torch.float32):
        super().__init__()
        self.p6 = Conv(out_channels, out_channels, 3, stride=2, padding=1,
                       dtype=dtype)
        self.p7 = Conv(out_channels, out_channels, 3, stride=2, padding=1,
                       dtype=dtype)

    def reset_parameters(self, gen: torch.Generator):
        for m in (self.p6, self.p7):
            init_variance_scaling(m.weight, 1.0 / 3.0, "fan_in", "uniform", gen)

    def forward(self, p5: torch.Tensor):
        p6 = self.p6(p5)
        return p6, self.p7(F.relu(p6))
