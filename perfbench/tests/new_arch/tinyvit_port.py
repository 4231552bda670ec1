"""A test's stand-in for the port's module of a new architecture: a tiny
plain-ViT backbone (a patch embedding, one attention block, then P2-P5 and
the pool level at 256 channels from its stride-16 map) that DG Faster
R-CNN's detector takes in place of its ResNet-50 FPN. `attention` counts its
calls in `attention_launches`, as the port's kernels count theirs."""

import math

import torch
import torch.nn.functional as F
from torch import nn

attention_launches = 0


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v over [B, heads, N, d]."""
    global attention_launches
    attention_launches += 1
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    return w @ v


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.dtype = stride, dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), self.stride)


class Linear(nn.Module):
    def __init__(self, din, dout, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


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
        self.embed = Conv(3, dim, patch, patch, dtype)
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, mlp, dtype)
        self.fc2 = Linear(mlp, dim, dtype)
        self.out = Conv(dim, out_channels, 1, 1, dtype)

    def forward(self, x):
        t = self.embed(x)
        B, D, h, w = t.shape
        t = t.flatten(2).transpose(1, 2).float()
        qkv = self.qkv(self.norm1(t)).float().reshape(
            B, h * w, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        a = attention(qkv[0], qkv[1], qkv[2])
        t = t + self.proj(a.transpose(1, 2).reshape(B, h * w, D)).float()
        t = t + self.fc2(F.gelu(self.fc1(self.norm2(t)))).float()
        p4 = self.out(t.transpose(1, 2).reshape(B, D, h, w))
        p5 = F.max_pool2d(p4, 1, 2)
        levels = [F.interpolate(p4, scale_factor=4.0, mode="nearest"),
                  F.interpolate(p4, scale_factor=2.0, mode="nearest"),
                  p4, p5, F.max_pool2d(p5, 1, 2)]
        return [p.contiguous(memory_format=torch.channels_last)
                for p in levels], {}
