"""ViTDet-B as DG Faster R-CNN's backbone (Li, Mao, Girshick, He,
"Exploring Plain Vision Transformer Backbones for Object Detection",
arXiv:2203.16527; detectron2's projects/ViTDet,
modeling/backbone/vit.py and utils.py).

- pixels normalised on 0-255 RGB by ImageNet's mean and std;
- a 16x16 patch embedding at stride 16, plus the absolute position
  embedding of 224 pretraining (14x14 and a class token, which is dropped),
  interpolated bicubically to the token grid at every forward;
- 12 pre-norm blocks: LayerNorm (eps 1e-6), 12-head attention with a qkv
  bias (its q, k and v parts three leaves, see `Attention`) and decomposed
  relative positions (q R_h and q R_w added to the
  logits, q unscaled; `ops/attention.py`, kernels K7/K8 on the card),
  drop-path, LayerNorm, an MLP 768 -> 3,072 -> 768 with GELU, drop-path.
  Blocks 2, 5, 8, 11 attend globally (relative tables of 2 * 64 - 1 rows,
  sized for 1024 inputs and interpolated to the grid at every forward);
  the others inside 14x14 windows of the grid zero-padded to a multiple of
  14, the padded tokens taking part as keys, unmasked;
- drop-path at rates growing linearly from 0 to 0.1 over the blocks: one
  mask per image and branch, kept where the draw's uniform is below the
  keep rate, the kept branch scaled by 1 / keep. The uniforms are inputs
  (`Draws.drop_path`, [B, depth, 2]); without them (predict) no branch
  drops;
- the simple feature pyramid from the last block alone at scales 4, 2, 1
  and 1/2 (2x2 transposed convs with a channel LayerNorm and GELU between,
  or a 2x2 max pool), each scale a 1x1 and a 3x3 conv without bias, each
  followed by a channel LayerNorm, and the pool level as
  `LastLevelMaxPool`: P2-P6 at strides 4-64, 256 channels, as the ResNet
  FPN gives them.

Parameters are float32; the patch embedding, the linear layers and the
pyramid's convs compute in the model's dtype. The residual stream is
float32; LayerNorm and the softmax's statistics are float32.

The program's spans: `dgod.vit.embed`, `dgod.vit.window` (each window
block), `dgod.vit.global` (each global block), `dgod.sfp`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import rel_index, rel_pos_table, relpos_attention, \
    relpos_terms
from ..utils.logging import span
from .layers import Conv, Dense, init_normal, init_variance_scaling


class ViTDetConfig(NamedTuple):
    """ViTDet-B as published (detectron2's mask_rcnn_vitdet_b_100ep.py)."""
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    drop_path_rate: float = 0.1
    pretrain_img_size: int = 224  # the absolute position embedding's
    img_size: int = 1024  # the global blocks' relative tables'
    out_channels: int = 256
    scale_factors: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)
    layer_norm_eps: float = 1e-6
    pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375)

    @classmethod
    def of(cls, group: dict) -> "ViTDetConfig":
        """From a configuration file's group (lists for tuples)."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in group.items()})


def window_partition(x: torch.Tensor, size: int):
    """[B, H, W, C] -> ([B * nh * nw, size, size, C], (Hp, Wp)), the grid
    zero-padded to multiples of `size`."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % size, (-W) % size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // size, size, Wp // size, size, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, size, size, C), (Hp, Wp)


def window_unpartition(windows: torch.Tensor, size: int, pad_hw, hw):
    """`window_partition`'s inverse, the padding cut away."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp // size * (Wp // size))
    x = windows.view(B, Hp // size, Wp // size, size, size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W].contiguous() if (Hp, Wp) != (H, W) else x


class LayerNorm(nn.Module):
    """LayerNorm over the last dim in float32, output in `dtype`."""

    def __init__(self, c: int, eps: float, dtype=torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.eps).to(self.dtype)


class ChannelLayerNorm(LayerNorm):
    """detectron2's channel LayerNorm of an NCHW map, over its channels."""

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvTranspose(nn.Module):
    """2x2 transposed conv at stride 2, [Cin, Cout, 2, 2] float32 weight,
    computed in `dtype`."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=2)


class Attention(nn.Module):
    """Multi-head attention with a qkv bias and decomposed relative
    positions over a fixed KH x KW grid of tokens, [B, KH, KW, C] in and
    out. The qkv projection is one product whose q, k and v parts are
    three leaves (detectron2 holds one `qkv` leaf): the k part's bias has
    no gradient in exact arithmetic (softmax ignores a constant logit per
    row), and at initialisation the q and k parts' gradients are small
    beside v's, so in one leaf neither shows on its own."""

    def __init__(self, dim: int, heads: int, grid: Tuple[int, int],
                 table: Tuple[int, int], dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.q = Dense(dim, dim, dtype=dtype)
        self.k = Dense(dim, dim, dtype=dtype)
        self.v = Dense(dim, dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * table[0] - 1,
                                                  dim // heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * table[1] - 1,
                                                  dim // heads))
        self.register_buffer("rel_index_h", rel_index(grid[0]),
                             persistent=False)
        self.register_buffer("rel_index_w", rel_index(grid[1]),
                             persistent=False)

    def forward(self, x):
        B, KH, KW, C = x.shape
        parts = (self.q, self.k, self.v)
        dtype = self.q.dtype
        qkv = F.linear(x.to(dtype),
                       torch.cat([p.weight for p in parts]).to(dtype),
                       torch.cat([p.bias for p in parts]).to(dtype))
        qkv = qkv.reshape(B, KH * KW, 3, self.heads, -1)
        rel_h, rel_w = relpos_terms(
            qkv[:, :, 0], rel_pos_table(self.rel_pos_h, KH, self.rel_index_h),
            rel_pos_table(self.rel_pos_w, KW, self.rel_index_w), (KH, KW))
        out = relpos_attention(qkv, rel_h, rel_w, self.scale)
        return self.proj(out.reshape(B, KH, KW, C))


class Block(nn.Module):
    """A pre-norm transformer block, windowed (`window` > 0) or global."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, grid, table,
                 window: int, drop_rate: float, eps: float,
                 dtype=torch.float32):
        super().__init__()
        self.window, self.drop_rate = window, drop_rate
        self.norm1 = LayerNorm(dim, eps, dtype)
        self.attn = Attention(dim, heads, (window, window) if window
                              else grid, table, dtype)
        self.norm2 = LayerNorm(dim, eps, dtype)
        self.mlp_fc1 = Dense(dim, mlp_dim, dtype=dtype)
        self.mlp_fc2 = Dense(mlp_dim, dim, dtype=dtype)

    def drop(self, y, u: Optional[torch.Tensor]):
        """The branch `y` (float32) under drop-path, given each image's
        uniform `u` [B] of this branch; None: no drop."""
        y = y.float()
        if u is None or self.drop_rate == 0.0:
            return y
        keep = 1.0 - self.drop_rate
        mask = (u < keep).float() / keep
        return y * mask[:, None, None, None]

    def forward(self, x, u: Optional[torch.Tensor] = None):
        """x [B, H, W, C] float32; u [B, 2]: the drop-path uniforms of the
        attention and MLP branches, or None."""
        y = self.norm1(x)
        if self.window:
            H, W = y.shape[1:3]
            y, pad_hw = window_partition(y, self.window)
        y = self.attn(y)
        if self.window:
            y = window_unpartition(y, self.window, pad_hw, (H, W))
        x = x + self.drop(y, None if u is None else u[:, 0])
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop(y, None if u is None else u[:, 1])


class ViT(nn.Module):
    """The plain ViT of ViTDet: NCHW normalised images -> [B, H, W, C]
    float32 tokens of the last block."""

    def __init__(self, grid: Tuple[int, int], config: ViTDetConfig,
                 dtype=torch.float32):
        super().__init__()
        c = config
        self.grid = tuple(grid)
        self.patch_embed = Conv(3, c.embed_dim, c.patch_size,
                                stride=c.patch_size, dtype=dtype)
        side = c.pretrain_img_size // c.patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, side * side + 1,
                                                  c.embed_dim))
        table = c.img_size // c.patch_size
        # each block's drop-path rate, as detectron2 spaces them (float32)
        rates = torch.linspace(0, c.drop_path_rate, c.depth).tolist()
        self.blocks = nn.ModuleList(
            Block(c.embed_dim, c.num_heads, int(c.embed_dim * c.mlp_ratio),
                  grid, (table, table) if i in c.global_blocks
                  else (c.window_size,) * 2,
                  0 if i in c.global_blocks else c.window_size, rates[i],
                  c.layer_norm_eps, dtype)
            for i in range(c.depth))

    def abs_pos(self) -> torch.Tensor:
        """`get_abs_pos`: the embedding without its class token,
        interpolated bicubically to the grid -> [1, H, W, C]."""
        pos = self.pos_embed[:, 1:]
        side = int(math.sqrt(pos.shape[1]))
        pos = pos.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        if (side, side) != self.grid:
            pos = F.interpolate(pos, size=self.grid, mode="bicubic",
                                align_corners=False)
        return pos.permute(0, 2, 3, 1)

    def forward(self, x, drop_path: Optional[torch.Tensor] = None):
        with span("dgod.vit.embed"):
            t = self.patch_embed(x).permute(0, 2, 3, 1)
            t = t.float() + self.abs_pos()
        for i, block in enumerate(self.blocks):
            with span("dgod.vit.window" if block.window
                      else "dgod.vit.global"):
                t = block(t, None if drop_path is None else drop_path[:, i])
        return t


class PyramidLevel(nn.Module):
    """One scale of the simple feature pyramid: the last block's map
    resampled by `scale`, then a 1x1 and a 3x3 conv, each followed by a
    channel LayerNorm."""

    def __init__(self, scale: float, dim: int, out_channels: int,
                 eps: float, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        c = dim
        if scale == 4.0:
            self.up1 = ConvTranspose(dim, dim // 2, dtype)
            self.up_norm = ChannelLayerNorm(dim // 2, eps, dtype)
            self.up2 = ConvTranspose(dim // 2, dim // 4, dtype)
            c = dim // 4
        elif scale == 2.0:
            self.up1 = ConvTranspose(dim, dim // 2, dtype)
            c = dim // 2
        elif scale not in (1.0, 0.5):
            raise ValueError(f"no pyramid level at scale {scale}")
        self.lateral = Conv(c, out_channels, 1, bias=False, dtype=dtype)
        self.lateral_norm = ChannelLayerNorm(out_channels, eps, dtype)
        self.output = Conv(out_channels, out_channels, 3, padding=1,
                           bias=False, dtype=dtype)
        self.output_norm = ChannelLayerNorm(out_channels, eps, dtype)

    def forward(self, x):
        if self.scale == 4.0:
            x = self.up2(F.gelu(self.up_norm(self.up1(x))))
        elif self.scale == 2.0:
            x = self.up1(x)
        elif self.scale == 0.5:
            x = F.max_pool2d(x, 2, 2)
        x = self.lateral_norm(self.lateral(x))
        return self.output_norm(self.output(x))


class ViTDetBackbone(nn.Module):
    """NCHW images in [0, 1] on a fixed canvas -> ([P2, P3, P4, P5, pool]
    NCHW in channels_last memory, {}), strides 4, 8, 16, 32, 64.

    What the code around it reads (as of backbone.ResNetTraits): a
    drop-path in every block; Adam at ViTDet's lr 1e-4 with weight decay
    1e-4 (its AdamW with layer decay is not ported); no split over the
    model axis (only the heads would split, and the trunk would stay whole
    on every rank); no torchvision weights."""

    optimizer = ("adam", 1e-4, 1e-4)
    splits_over_model_axis = False
    torchvision_weights = False

    def __init__(self, canvas: Tuple[int, int],
                 config: ViTDetConfig = ViTDetConfig(), dtype=torch.float32):
        super().__init__()
        self.config = config
        self.drop_path_depth = config.depth
        p = config.patch_size
        self.net = ViT((canvas[0] // p, canvas[1] // p), config, dtype)
        self.levels = nn.ModuleList(
            PyramidLevel(s, config.embed_dim, config.out_channels,
                         config.layer_norm_eps, dtype)
            for s in config.scale_factors)
        # on [0, 1] pixels: the 0-255 mean and std over 255
        self.register_buffer("pixel_mean", torch.tensor(
            config.pixel_mean)[:, None, None] / 255.0, persistent=False)
        self.register_buffer("pixel_std", torch.tensor(
            config.pixel_std)[:, None, None] / 255.0, persistent=False)

    def reset_parameters(self, gen: torch.Generator):
        """detectron2's initialisers: the linear layers, the position
        embedding and (not zero, as random weights need them live) the
        relative tables at std 0.02; the patch embedding and the transposed
        convs at PyTorch's default variance, 1 / (3 fan_in); the pyramid's
        convs at 1 / fan_in (c2_xavier_fill)."""
        net = self.net
        init_variance_scaling(net.patch_embed.weight, 1.0 / 3.0, "fan_in",
                              "truncated_normal", gen)
        init_normal(net.pos_embed, 0.02, gen)
        for block in net.blocks:
            attn = block.attn
            for t in (attn.q.weight, attn.k.weight, attn.v.weight,
                      attn.proj.weight,
                      block.attn.rel_pos_h, block.attn.rel_pos_w,
                      block.mlp_fc1.weight, block.mlp_fc2.weight):
                init_normal(t, 0.02, gen)
        for level in self.levels:
            for name in ("up1", "up2"):
                if hasattr(level, name):
                    init_variance_scaling(getattr(level, name).weight,
                                          1.0 / 3.0, "fan_in",
                                          "truncated_normal", gen)
            for conv in (level.lateral, level.output):
                init_variance_scaling(conv.weight, 1.0, "fan_in",
                                      "truncated_normal", gen)

    def forward(self, x, drop_path: Optional[torch.Tensor] = None):
        """x NCHW in [0, 1]; drop_path [B, depth, 2] uniforms or None."""
        x = (x - self.pixel_mean) / self.pixel_std
        t = self.net(x, drop_path).permute(0, 3, 1, 2)
        with span("dgod.sfp"):
            ps = [level(t).contiguous(memory_format=torch.channels_last)
                  for level in self.levels]
            return ps + [F.max_pool2d(ps[-1], 1, 2)], {}
