"""ResNet-50 with frozen batch-norm (port of dgod_tpu/models/resnet.py).

torchvision resnet50 v1.5 (stride on the 3x3 conv). FrozenBatchNorm's four
tensors are buffers: nothing trains them. Module and parameter names mirror
the JAX parameter tree (`layer{s}_block{i}/Conv_{0,1,2}`, `bn{1,2,3}`,
`downsample_conv`, `downsample_bn`) so `utils/weights.params_from_jax` maps
one to the other by name. The stem is the plain 7x7/2 conv: the JAX
package's space-to-depth stem is a TPU rewrite of the same function.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, init_variance_scaling


class FrozenBatchNorm(nn.Module):
    """y = x * inv + shift, inv = scale / sqrt(var + eps) in float32, then
    cast to the compute dtype (torchvision FrozenBatchNorm2d, eps 1e-5)."""

    def __init__(self, c: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.scale / torch.sqrt(self.var + self.eps)
        shift = self.bias - self.mean * inv
        return (x * inv.to(self.dtype)[None, :, None, None]
                + shift.to(self.dtype)[None, :, None, None])


def _conv(cin, cout, k, stride=1, padding=0, dtype=torch.float32):
    return Conv(cin, cout, k, stride, padding, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        cout = features * 4
        self.Conv_0 = _conv(cin, features, 1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(features, dtype=dtype)
        self.Conv_1 = _conv(features, features, 3, stride, 1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(features, dtype=dtype)
        self.Conv_2 = _conv(features, cout, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(cout, dtype=dtype)
        if downsample:
            self.downsample_conv = _conv(cin, cout, 1, stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(cout, dtype=dtype)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.Conv_0(x)))
        out = F.relu(self.bn2(self.Conv_1(out)))
        out = self.bn3(self.Conv_2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """NCHW in, {'c2'..'c5'} out (strides 4..32). `block_counts` cuts depth
    and keeps every stage, stride and width."""

    def __init__(self, dtype=torch.float32,
                 block_counts: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.dtype = dtype
        self.block_counts = tuple(block_counts)
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype=dtype)
        cin = 64
        for stage, (count, width) in enumerate(
                zip(self.block_counts, (64, 128, 256, 512)), start=1):
            for i in range(count):
                stride = 2 if (i == 0 and stage > 1) else 1
                self.add_module(f"layer{stage}_block{i}", Bottleneck(
                    cin, width, stride, downsample=(i == 0), dtype=dtype))
                cin = width * 4

    def reset_parameters(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, Conv):
                init_variance_scaling(m.weight, 2.0, "fan_out", "normal", gen)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = {}
        for stage, count in enumerate(self.block_counts, start=1):
            for i in range(count):
                x = getattr(self, f"layer{stage}_block{i}")(x)
            feats[f"c{stage + 1}"] = x
        return feats
