"""The plain reference of ViTDet-B as DG Faster R-CNN's backbone (Li, Mao,
Girshick, He, arXiv:2203.16527): detectron2's
projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py, with
modeling/backbone/vit.py (ViT, Block, Attention, SimpleFeaturePyramid) and
utils.py (window_partition, window_unpartition, get_rel_pos,
add_decomposed_rel_pos, get_abs_pos), equation for equation, in plain
torch: no kernel, nothing of dgod_tpu_torch or of JAX. It attaches to the
reference's DGFRCNNModel by a subclass (`DGFRCNNModel` below) whose
detector's backbone is this one, and whose `Draws` carry the drop-path
uniforms.

Departures from detectron2, each for a reason:
- precision, the configuration's: the patch embedding, the linear layers
  and the pyramid's convs compute in `dtype` (layers.Dense, layers.Conv,
  so that the fp8 control reaches them; the transposed convs are a Conv
  too); the residual stream is float32; LayerNorm takes float32
  statistics and returns `dtype`; the logits q k^T are float32 products of
  the `dtype` q and k, q R_h and q R_w float32, the softmax float32, and
  its probabilities meet v in v's dtype;
- drop-path takes its masks from given uniforms [B, depth, 2] (the Draws):
  a branch is kept where its image's uniform is below the keep rate
  (timm's bernoulli(keep)), then scaled by 1 / keep;
- the relative tables are initialised at std 0.02, not at zero
  (rel_pos_zero_init=False), so that random weights exercise them; the
  initialisers record each leaf's standard deviation and draw nothing
  (perfbench/bench/models.py::make_state makes the weights);
- the pixels arrive in [0, 1] (the detector divides by 255), so they are
  normalised by the 0-255 mean and std over 255;
- get_rel_pos builds its coordinates on the table's device;
- the qkv projection's q, k and v parts are three leaves (`q`, `k`, `v`),
  as the program holds them: the k part's bias has no gradient in exact
  arithmetic, and the q and k parts' gradients are small beside v's at
  initialisation, so one leaf's norm would hide both from the check;
- in the benchmark's check, the proposals of the first training
  forwards may be given (`DGFRCNNModel.follow_proposals`: the program's,
  recorded by perfbench/builders/vitdet.py), since near-tied RPN scores
  let rounding pick others; proposals take no gradient;
- the detector is the reference's DG Faster R-CNN: its ResNet-50 FPN
  (built at its least, blocks (1, 1, 1, 1)) is replaced by this backbone,
  with its RPN, RoI and DG heads as they are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dg_frcnn, layers


class Draws(NamedTuple):
    """The reference DG Faster R-CNN's draws and the drop-path uniforms."""
    rpn_pos: Optional[torch.Tensor]
    rpn_neg: Optional[torch.Tensor]
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor
    drop_path: Optional[torch.Tensor] = None  # [B, depth, 2]


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(
        -1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size,
                     window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(
            rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
            size=max_rel_dist, mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(
            1, 0)
    else:
        rel_pos_resized = rel_pos
    device = rel_pos.device
    q_coords = torch.arange(q_size, device=device)[:, None] * max(
        k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=device)[None, :] * max(
        q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(
        q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def get_abs_pos(abs_pos, has_cls_token, hw):
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    xy_num = abs_pos.shape[1]
    size = int(math.sqrt(xy_num))
    assert size * size == xy_num
    if size != h or size != w:
        new_abs_pos = F.interpolate(
            abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2),
            size=(h, w), mode="bicubic", align_corners=False)
        return new_abs_pos.permute(0, 2, 3, 1)
    return abs_pos.reshape(1, h, w, -1)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim (float32 statistics), output in
    `dtype`."""

    def __init__(self, c, eps, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps, self.dtype = eps, dtype

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight,
                            self.bias, self.eps).to(self.dtype)


class ChannelLayerNorm(LayerNorm):
    """detectron2's LayerNorm of layers/batch_norm.py: over dim 1 of
    NCHW."""

    def forward(self, x):
        x = x.float()
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return (self.weight[:, None, None] * x
                + self.bias[:, None, None]).to(self.dtype)


class ConvTranspose(layers.Conv):
    """nn.ConvTranspose2d(cin, cout, 2, stride 2) as a layers.Conv: a
    [cin, cout, 2, 2] float32 weight, computed in `dtype`, on fp8 operands
    where `fp8` is set."""

    def __init__(self, cin, cout, dtype):
        super().__init__(cin, cout, 2, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if getattr(self, "fp8", False):
            x, w = layers.fp8_round(x), layers.fp8_round(w)
        return F.conv_transpose2d(x, w, self.bias.to(self.dtype), stride=2)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size, dtype):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.q = layers.Dense(dim, dim, dtype=dtype)
        self.k = layers.Dense(dim, dim, dtype=dtype)
        self.v = layers.Dense(dim, dim, dtype=dtype)
        self.proj = layers.Dense(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = torch.stack([self.q(x), self.k(x), self.v(x)], 3).reshape(
            B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        attn = (q.float() * self.scale) @ k.float().transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q.float(), self.rel_pos_h,
                                      self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn.to(v.dtype) @ v).view(B, self.num_heads, H, W, -1).permute(
            0, 2, 3, 1, 4).reshape(B, H, W, -1)
        return self.proj(x)


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, drop_path, window_size,
                 input_size, eps, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps, dtype)
        self.attn = Attention(dim, num_heads, (window_size, window_size)
                              if window_size > 0 else input_size, dtype)
        self.drop_rate = drop_path
        self.norm2 = LayerNorm(dim, eps, dtype)
        self.mlp_fc1 = layers.Dense(dim, mlp_dim, dtype=dtype)
        self.mlp_fc2 = layers.Dense(mlp_dim, dim, dtype=dtype)
        self.window_size = window_size

    def drop_path(self, x, u):
        x = x.float()
        if u is None or self.drop_rate == 0.0:
            return x
        keep_prob = 1.0 - self.drop_rate
        random_tensor = (u < keep_prob).float().view(-1, 1, 1, 1)
        return x * random_tensor.div(keep_prob)

    def forward(self, x, u=None):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + self.drop_path(x, None if u is None else u[:, 0])
        mlp = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path(mlp, None if u is None else u[:, 1])


class ViT(nn.Module):
    def __init__(self, vit: dict, dtype):
        super().__init__()
        p, dim = vit["patch_size"], vit["embed_dim"]
        self.patch_embed = layers.Conv(3, dim, p, stride=p, dtype=dtype)
        num_patches = (vit["pretrain_img_size"] // p) ** 2
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, dim))
        dpr = [x.item() for x in torch.linspace(0, vit["drop_path_rate"],
                                                vit["depth"])]
        size = vit["img_size"] // p
        self.blocks = nn.ModuleList(
            Block(dim, vit["num_heads"], int(dim * vit["mlp_ratio"]), dpr[i],
                  0 if i in vit["global_blocks"] else vit["window_size"],
                  (size, size), vit["layer_norm_eps"], dtype)
            for i in range(vit["depth"]))

    def forward(self, x, drop_path=None):
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = x.float() + get_abs_pos(self.pos_embed, True,
                                    (x.shape[1], x.shape[2]))
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if drop_path is None else drop_path[:, i])
        return x.permute(0, 3, 1, 2)


class PyramidLevel(nn.Module):
    """SimpleFeaturePyramid's stage at `scale`, then its two Conv2d with
    norm="LN", without bias."""

    def __init__(self, scale, dim, out_channels, eps, dtype):
        super().__init__()
        self.scale = scale
        out_dim = dim
        if scale == 4.0:
            self.up1 = ConvTranspose(dim, dim // 2, dtype)
            self.up_norm = ChannelLayerNorm(dim // 2, eps, dtype)
            self.up2 = ConvTranspose(dim // 2, dim // 4, dtype)
            out_dim = dim // 4
        elif scale == 2.0:
            self.up1 = ConvTranspose(dim, dim // 2, dtype)
            out_dim = dim // 2
        self.lateral = layers.Conv(out_dim, out_channels, 1, bias=False,
                                   dtype=dtype)
        self.lateral_norm = ChannelLayerNorm(out_channels, eps, dtype)
        self.output = layers.Conv(out_channels, out_channels, 3, padding=1,
                                  bias=False, dtype=dtype)
        self.output_norm = ChannelLayerNorm(out_channels, eps, dtype)

    def forward(self, x):
        if self.scale == 4.0:
            x = self.up2(F.gelu(self.up_norm(self.up1(x))))
        elif self.scale == 2.0:
            x = self.up1(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x, kernel_size=2, stride=2)
        return self.output_norm(self.output(self.lateral_norm(
            self.lateral(x))))


class Backbone(nn.Module):
    """NCHW images in [0, 1] -> ([P2, P3, P4, P5, pool], {}), strides
    4-64. `drop_path`, where set ([B, depth, 2] uniforms), is the
    drop-path of the loss evaluation in progress."""

    def __init__(self, vit: dict, dtype=torch.float32):
        super().__init__()
        self.net = ViT(vit, dtype)
        self.levels = nn.ModuleList(
            PyramidLevel(s, vit["embed_dim"], vit["out_channels"],
                         vit["layer_norm_eps"], dtype)
            for s in vit["scale_factors"])
        self.register_buffer("pixel_mean", torch.tensor(
            vit["pixel_mean"]).view(-1, 1, 1), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            vit["pixel_std"]).view(-1, 1, 1), persistent=False)
        self.drop_path = None

    def reset_parameters(self, spec: list) -> None:
        net = self.net
        layers.init_variance_scaling(net.patch_embed.weight, 1.0 / 3.0,
                                     "fan_in", "truncated_normal", spec)
        layers.init_normal(net.pos_embed, 0.02, spec)
        for blk in net.blocks:
            for t in (blk.attn.q.weight, blk.attn.k.weight,
                      blk.attn.v.weight, blk.attn.proj.weight,
                      blk.attn.rel_pos_h, blk.attn.rel_pos_w,
                      blk.mlp_fc1.weight, blk.mlp_fc2.weight):
                layers.init_normal(t, 0.02, spec)
        for level in self.levels:
            for name in ("up1", "up2"):
                if hasattr(level, name):
                    layers.init_variance_scaling(
                        getattr(level, name).weight, 1.0 / 3.0, "fan_in",
                        "truncated_normal", spec)
            for conv in (level.lateral, level.output):
                layers.init_variance_scaling(conv.weight, 1.0, "fan_in",
                                             "truncated_normal", spec)

    def forward(self, x):
        x = (x - self.pixel_mean / 255.0) / (self.pixel_std / 255.0)
        features = self.net(x, self.drop_path)
        results = [level(features) for level in self.levels]
        results.append(F.max_pool2d(results[-1], kernel_size=1, stride=2,
                                    padding=0))
        return [p.contiguous(memory_format=torch.channels_last)
                for p in results], {}


class DGFRCNNModel(dg_frcnn.DGFRCNNModel):
    """The reference DG Faster R-CNN on this backbone, sized by `vit` (the
    configuration's `vit` group); the other arguments are the reference
    DGFRCNNModel's. Each loss evaluation takes its drop-path uniforms from
    its Draws (`Draws` above)."""

    def __init__(self, vit: dict, compute_dtype=torch.float32, **kwargs):
        kwargs["backbone_block_counts"] = (1, 1, 1, 1)
        super().__init__(compute_dtype=compute_dtype, **kwargs)
        backbone = Backbone(vit, compute_dtype)
        self.detector.backbone = backbone.to(self.device)
        spec = []
        backbone.reset_parameters(spec)
        held = {id(p) for p in self.parameters()}
        self.init_spec = spec + [(t, s) for t, s in self.init_spec
                                 if id(t) in held]

    def follow_proposals(self, tape: list) -> None:
        """Take the proposals of the next training forwards from `tape`,
        one (boxes [B', Npost, 4], valid [B', Npost]) each, in order, the
        first rows of each, in place of the detector's own; a forward of
        more images than its entry holds, and every forward after the
        tape's last, computes its own."""
        detector = self.detector
        own = detector.generate_proposals
        entries = iter(tape)

        def generate_proposals(objectness, deltas, image_sizes, training):
            entry = next(entries, None) if training else None
            rows = objectness[0].shape[0]
            if entry is None or entry[0].shape[0] < rows:
                return own(objectness, deltas, image_sizes, training)
            boxes, valid = entry
            return boxes[:rows], valid[:rows], None

        detector.generate_proposals = generate_proposals

    def loss_for_mode(self, batch, draws, mode, reg_weights, **kwargs):
        backbone = self.detector.backbone
        backbone.drop_path = draws.drop_path
        try:
            return super().loss_for_mode(batch, draws, mode, reg_weights,
                                         **kwargs)
        finally:
            backbone.drop_path = None
