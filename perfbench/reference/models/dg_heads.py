"""Domain-generalisation heads for Faster R-CNN and FCOS (port of
dgod_tpu/models/dg_heads.py). All run in float32, also under a bf16 model.

- `grad_reverse`: identity forward, backward multiplies by -alpha (0.1).
- `ImageDAFPN` (FRCNN): image-level domain classifier on P2: 4 VALID convs
  with strides (2,4)/4/4/3 -> 256 -> 128 -> D, sigmoid. Inputs smaller than
  the 608x1216 canvas's P2 are zero-padded up to the smallest size that
  still reduces to 1x1.
- `ImageDA` (FCOS): the same on C5: VALID convs 2048 -> 1024 -> 512 -> 256
  with strides (2,4)/2/2 -> 128 -> D, sigmoid; padded up to (19, 35).
- `MLPHead` (`frcnn_instance_da`, `frcnn_ins_cls` on 1024-d RoI features;
  `fcos_instance_da`, `fcos_ins_cls` on 256-d location features): Dense
  stack with ReLU where the reference has it, optional GRL, sigmoid output.
- `DomainBank`: one head per domain with stacked `[D, in, out]` weights;
  `gather` applies each image's own head, `all` every head to every image.

The sigmoid outputs are what the DG losses feed to the softmax CE (the
reference's quirk, kept). `param_group_labels` gives both DG models'
optimizer groups.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv, Dense, init_lecun_normal, init_normal,
                     init_variance_scaling)


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return _GradReverse.apply(x, alpha)


def pad_to_min(x: torch.Tensor, min_hw) -> torch.Tensor:
    """Zero-pad an NCHW map's bottom/right up to `min_hw` (no-op at the full
    canvas)."""
    ph = max(0, min_hw[0] - x.shape[2])
    pw = max(0, min_hw[1] - x.shape[3])
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    return x


class ImageDAFPN(nn.Module):
    """Image-level domain classifier over P2 (FRCNN variant)."""

    def __init__(self, num_domains: int):
        super().__init__()
        self.conv1 = Conv(256, 256, 3, stride=(2, 4))
        self.conv2 = Conv(256, 256, 3, stride=4)
        self.conv3 = Conv(256, 256, 3, stride=4)
        self.conv4 = Conv(256, 256, 3, stride=3)
        self.linear1 = Dense(256, 128)
        self.linear2 = Dense(128, num_domains)

    def reset_parameters(self, gen):
        for c in (self.conv1, self.conv2, self.conv3, self.conv4):
            init_normal(c.weight, 0.001, gen)
        init_lecun_normal(self.linear1.weight, gen)
        init_lecun_normal(self.linear2.weight, gen)

    def forward(self, p2: torch.Tensor) -> torch.Tensor:
        """p2 [B, H, W, 256] (NHWC, as the JAX head) -> [B, D] sigmoid."""
        x = pad_to_min(p2.float().permute(0, 3, 1, 2), (87, 171))
        x = grad_reverse(x)
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).flatten(1)  # HWC order, as Flax flattens
        x = F.relu(self.linear1(x))
        return torch.sigmoid(self.linear2(x))


class ImageDA(nn.Module):
    """Image-level domain classifier over C5 (FCOS variant)."""

    def __init__(self, num_domains: int):
        super().__init__()
        self.conv1 = Conv(2048, 1024, 3, stride=(2, 4))
        self.conv2 = Conv(1024, 512, 3, stride=2)
        self.conv3 = Conv(512, 256, 3, stride=2)
        self.linear1 = Dense(256, 128)
        self.linear2 = Dense(128, num_domains)

    def reset_parameters(self, gen):
        for c in (self.conv1, self.conv2, self.conv3):
            init_normal(c.weight, 0.001, gen)
        init_lecun_normal(self.linear1.weight, gen)
        init_lecun_normal(self.linear2.weight, gen)

    def forward(self, c5: torch.Tensor) -> torch.Tensor:
        """c5 [B, H, W, 2048] (NHWC, as the JAX head) -> [B, D] sigmoid."""
        x = pad_to_min(c5.float().permute(0, 3, 1, 2), (19, 35))
        x = grad_reverse(x)
        for conv in (self.conv1, self.conv2, self.conv3):
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).flatten(1)  # HWC order, as Flax flattens
        x = F.relu(self.linear1(x))
        return torch.sigmoid(self.linear2(x))


class MLPHead(nn.Module):
    """Dense stack (ReLU per `relu_mask`), optional GRL, sigmoid output."""

    def __init__(self, din: int, widths: Sequence[int],
                 relu_mask: Sequence[bool], use_grl: bool):
        super().__init__()
        self.widths = tuple(widths)
        self.relu_mask = tuple(relu_mask)
        self.use_grl = use_grl
        for i, w in enumerate(self.widths):
            self.add_module(f"fc{i}", Dense(din, w))
            din = w

    def reset_parameters(self, gen):
        for i in range(len(self.widths)):
            init_lecun_normal(getattr(self, f"fc{i}").weight, gen)

    def forward(self, x):
        if self.use_grl:
            x = grad_reverse(x)
        for i, r in enumerate(self.relu_mask):
            x = getattr(self, f"fc{i}")(x)
            if r:
                x = F.relu(x)
        return torch.sigmoid(x)


def frcnn_instance_da(num_domains: int, din: int = 1024) -> MLPHead:
    # 1024 -> 512 (relu) -> 256 (no relu) -> D, GRL
    return MLPHead(din, (512, 256, num_domains), (True, False, False), True)


def frcnn_ins_cls(num_classes: int, prime: bool, din: int = 1024) -> MLPHead:
    # 1024 -> 512 (relu) -> 256 (no relu) -> C; prime adds the GRL
    return MLPHead(din, (512, 256, num_classes), (True, False, False), prime)


def fcos_instance_da(num_domains: int, din: int = 256) -> MLPHead:
    # 256 -> 128 (relu) -> D, GRL
    return MLPHead(din, (128, num_domains), (True, False), True)


def fcos_ins_cls(num_classes: int, prime: bool, din: int = 256) -> MLPHead:
    # 256 -> 128 (relu) -> 64 (no relu) -> C; prime adds the GRL
    return MLPHead(din, (128, 64, num_classes), (True, False, False), prime)


class _StackedDense(nn.Module):
    """Dense layer with a leading domain axis: weight [D, in, out], bias
    [D, out] (the JAX bank's layout)."""

    def __init__(self, din: int, dout: int, num_domains: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_domains, din, dout))
        self.bias = nn.Parameter(torch.zeros(num_domains, dout))

    def reset_parameters(self, gen):
        # variance_scaling(1, fan_in, truncated_normal) per domain head
        init_variance_scaling(self.weight, 1.0, "fan_in", "truncated_normal",
                              gen, fan_in=self.weight.shape[1])

    def forward(self, x, domain: Optional[torch.Tensor], frozen: bool):
        w, b = self.weight, self.bias
        if frozen:
            w, b = w.detach(), b.detach()
        if domain is None:  # x [D, B, ..., in]
            y = torch.einsum("db...i,dio->db...o", x, w)
            return y + b.reshape((w.shape[0],) + (1,) * (y.dim() - 2)
                                 + (w.shape[2],))
        # x [B, ..., in]: select each image's head, then one batched matmul
        y = torch.einsum("b...i,bio->b...o", x, w[domain])
        return y + b[domain].reshape((x.shape[0],) + (1,) * (y.dim() - 2)
                                     + (w.shape[2],))


class _StackedMLP(nn.Module):
    def __init__(self, head: MLPHead, din: int, num_domains: int):
        super().__init__()
        self.widths = head.widths
        self.relu_mask = head.relu_mask
        self.use_grl = head.use_grl
        self.num_domains = num_domains
        for i, w in enumerate(self.widths):
            self.add_module(f"fc{i}", _StackedDense(din, w, num_domains))
            din = w

    def forward(self, x, domain, frozen):
        if self.use_grl:
            x = grad_reverse(x)
        if domain is None:  # 'all': broadcast over the domain axis
            x = x[None].expand((self.num_domains,) + x.shape)
        for i, r in enumerate(self.relu_mask):
            x = getattr(self, f"fc{i}")(x, domain, frozen)
            if r:
                x = F.relu(x)
        return torch.sigmoid(x)


class DomainBank(nn.Module):
    """`num_domains` identical heads with stacked params.

    gather (x [B, ..., F], domain [B]): each image's own head.
    all (x): every head on every image -> [D, B, ..., out].
    `frozen=True` stops the gradient into the bank's weights (mode 4)."""

    def __init__(self, head: MLPHead, num_domains: int, din: int = 1024):
        super().__init__()
        self.bank = _StackedMLP(head, din, num_domains)

    def reset_parameters(self, gen):
        for m in self.bank.children():
            m.reset_parameters(gen)

    def forward(self, x, domain=None, mode: str = "gather",
                frozen: bool = False):
        if mode == "all":
            return self.bank(x, None, frozen)
        return self.bank(x, domain.long(), frozen)


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> optimizer group of a DG model: 'frozen' (stem and
    layer1 of the ResNet body), 'detector', 'image_da', 'ins_da', 'ins_cls',
    'ins_cls_prime'. (FrozenBatchNorm tensors are buffers, in no group.)"""
    labels = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        group = keys[0]
        if group == "detector" and "body" in keys:
            rest = keys[keys.index("body") + 1:]
            if rest[0] == "conv1" or rest[0].startswith("layer1_"):
                group = "frozen"
        labels[name] = group
    return labels
