"""The plain reference of the TINYVIT stand-in's backbone (a patch
embedding, one attention block, P2-P5 and the pool level at 256 channels
from its stride-16 map), on the reference's own layers: its initialisers
record each leaf's scale and draw nothing."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import layers


class LayerNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias)


class Backbone(nn.Module):
    """NCHW images -> ([P2, P3, P4, P5, pool], {}), strides 4-64."""

    def __init__(self, patch, dim, heads, mlp, out_channels=256,
                 dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.embed = layers.Conv(3, dim, patch, stride=patch, dtype=dtype)
        self.norm1 = LayerNorm(dim)
        self.qkv = layers.Dense(dim, 3 * dim, dtype=dtype)
        self.proj = layers.Dense(dim, dim, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.fc1 = layers.Dense(dim, mlp, dtype=dtype)
        self.fc2 = layers.Dense(mlp, dim, dtype=dtype)
        self.out = layers.Conv(dim, out_channels, 1, dtype=dtype)

    def reset_parameters(self, spec: list) -> None:
        for m in (self.embed, self.qkv, self.proj, self.fc1, self.fc2,
                  self.out):
            layers.init_lecun_normal(m.weight, spec)

    def forward(self, x):
        t = self.embed(x)
        B, D, h, w = t.shape
        t = t.flatten(2).transpose(1, 2).float()
        q, k, v = self.qkv(self.norm1(t)).float().reshape(
            B, h * w, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        s = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]),
                          -1)
        a = s @ v
        t = t + self.proj(a.transpose(1, 2).reshape(B, h * w, D)).float()
        t = t + self.fc2(F.gelu(self.fc1(self.norm2(t)))).float()
        p4 = self.out(t.transpose(1, 2).reshape(B, D, h, w))
        p5 = F.max_pool2d(p4, 1, 2)
        levels = [F.interpolate(p4, scale_factor=4.0, mode="nearest"),
                  F.interpolate(p4, scale_factor=2.0, mode="nearest"),
                  p4, p5, F.max_pool2d(p5, 1, 2)]
        return [p.contiguous(memory_format=torch.channels_last)
                for p in levels], {}
