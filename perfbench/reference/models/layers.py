"""Conv / Dense layers with Flax-style compute dtype and initialisers.

Parameters stay float32 (as Flax keeps them); a layer casts its input and
parameters to its `dtype` at call time, so `dtype=torch.bfloat16` runs the
convolution or matmul in bf16, as `nn.Conv(dtype=...)` does in the JAX
package. Initialisers mirror the JAX ones (`init_*` below), drawn from an
explicit `torch.Generator`.

Convolutions are NCHW; fed a channels_last tensor they keep that memory
format, so `x.permute(0, 2, 3, 1)` is a contiguous NHWC view.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t` rounded to `dtype` under one scale for the tensor (its largest
    magnitude onto the format's largest finite value), in t's dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _FP8Round(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2, each scaled per
    tensor: the rounding of an fp8 training step whose products accumulate
    in float32."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad, torch.float8_e5m2)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """The operand of an fp8 matmul or convolution (`_FP8Round`). The
    precision control sets `fp8` on every Conv and Dense
    (perfbench/control.py)."""
    return _FP8Round.apply(t)


def _fans(shape):
    """(fan_in, fan_out) for an OIHW conv or [out, in] dense weight."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def init_normal(t: torch.Tensor, std: float, gen):
    if isinstance(gen, list):  # record the leaf's scale; draw nothing
        gen.append((t, std))
        return
    with torch.no_grad():
        t.normal_(0.0, std, generator=gen)


def init_variance_scaling(t: torch.Tensor, scale: float, mode: str,
                          distribution: str, gen: torch.Generator,
                          fan_in: Optional[int] = None):
    """jax.nn.initializers.variance_scaling on a torch-layout weight."""
    fi, fo = _fans(t.shape)
    fan = fan_in if fan_in is not None else (fi if mode == "fan_in" else fo)
    var = scale / fan
    if isinstance(gen, list):  # record the leaf's standard deviation
        gen.append((t, math.sqrt(var)))
        return
    with torch.no_grad():
        if distribution == "normal":
            t.normal_(0.0, math.sqrt(var), generator=gen)
        elif distribution == "uniform":
            lim = math.sqrt(3.0 * var)
            t.uniform_(-lim, lim, generator=gen)
        elif distribution == "truncated_normal":
            # std of a unit normal truncated to [-2, 2]
            std = math.sqrt(var) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
        else:
            raise ValueError(distribution)


def init_lecun_normal(t: torch.Tensor, gen: torch.Generator):
    """Flax's default kernel init."""
    init_variance_scaling(t, 1.0, "fan_in", "truncated_normal", gen)


class Conv(nn.Module):
    """2-D convolution, OIHW float32 weight, computed in `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride=1, padding=0,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride if isinstance(stride, tuple) else (stride, stride)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if getattr(self, "fp8", False):
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, b, self.stride, self.padding)


class GroupNorm(nn.Module):
    """Flax's GroupNorm on NCHW: groups of consecutive channels, statistics
    in float32 with the variance as E[x^2] - E[x]^2 (clipped at 0), trainable
    per-channel `scale`/`bias` (float32), output cast to `dtype`."""

    def __init__(self, c: int, num_groups: int = 32, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        xf = x.float()
        g = xf.reshape(B, self.num_groups, C // self.num_groups * H * W) \
            if x.is_contiguous() else \
            xf.permute(0, 2, 3, 1).reshape(B, H * W, self.num_groups, -1)
        dims = (2,) if x.is_contiguous() else (1, 3)
        mean = g.mean(dims)  # [B, groups]
        var = ((g * g).mean(dims) - mean * mean).clamp(min=0.0)
        rep = C // self.num_groups
        mean = mean.repeat_interleave(rep, 1)[:, :, None, None]
        var = var.repeat_interleave(rep, 1)[:, :, None, None]
        mul = torch.rsqrt(var + self.eps) * self.scale[None, :, None, None]
        y = (xf - mean) * mul + self.bias[None, :, None, None]
        return y.to(self.dtype)


class Dense(nn.Module):
    """Dense layer, [out, in] float32 weight, computed in `dtype` (None:
    float32, Flax's dtype inference for float32 inputs)."""

    def __init__(self, din: int, dout: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout))
        self.dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if getattr(self, "fp8", False):
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x, w, self.bias.to(self.dtype))
