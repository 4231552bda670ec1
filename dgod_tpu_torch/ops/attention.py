"""Attention with decomposed relative positions (ViTDet's
`add_decomposed_rel_pos`, detectron2/modeling/backbone/utils.py), the plain
version: kernels K7 (forward) and K8 (backward) in `cuda_attention.py`
compute the same on the card, and `relpos_attention` sends a call to one or
the other by the device of its tensors.

    out = softmax(scale * q k^T + rel_h (+) rel_w) v

Layouts, as the ViT block holds them:
- qkv [B, N, 3, heads, D]: the qkv projection's output, unpermuted;
- rel_h [B, heads, N, KH] and rel_w [B, heads, N, KW], float32: q R_h and
  q R_w (`relpos_terms`), where the tokens, queries and keys alike, lie
  row-major on a KH x KW grid, so key n is at row n // KW and column
  n % KW, and the logit of query m and key n gains
  rel_h[m, n // KW] + rel_w[m, n % KW];
- out [B, N, heads, D], in qkv's dtype, ready for the output projection.

The logits and softmax are float32: the products of q and k are exact in
float32 from bf16 operands, as the tensor cores form them; the
probabilities meet v in v's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rel_index(size: int) -> torch.Tensor:
    """[size, size] long: the entry of a (2 * size - 1)-row table that query
    i takes for key j, i - j + size - 1 (`get_rel_pos` with equal query and
    key sizes)."""
    coords = torch.arange(size)
    return coords[:, None] - coords[None, :] + (size - 1)


def rel_pos_table(table: torch.Tensor, size: int,
                  index: torch.Tensor) -> torch.Tensor:
    """`get_rel_pos`: the [L, D] table linearly interpolated to 2 * size - 1
    rows where it has another length, then gathered by `index`
    (`rel_index(size)`, on the table's device) -> [size, size, D]."""
    rows = 2 * size - 1
    if table.shape[0] != rows:
        table = F.interpolate(table.t()[None], size=rows,
                              mode="linear")[0].t()
    return table[index]


def relpos_terms(q: torch.Tensor, table_h: torch.Tensor,
                 table_w: torch.Tensor, grid: Tuple[int, int]):
    """q [B, N, heads, D] (unscaled), the tables R_h [KH, KH, D] and R_w
    [KW, KW, D] (`rel_pos_table`) -> (rel_h [B, heads, N, KH], rel_w
    [B, heads, N, KW]) in float32."""
    B, N, heads, D = q.shape
    KH, KW = grid
    r_q = q.float().permute(0, 2, 1, 3).reshape(B, heads, KH, KW, D)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, table_h.float())
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, table_w.float())
    return rel_h.reshape(B, heads, N, KH), rel_w.reshape(B, heads, N, KW)


def relpos_attention_plain(qkv: torch.Tensor, rel_h: torch.Tensor,
                           rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention of the module's docstring, with the [B, heads, N, N]
    logits materialised."""
    B, N, _, heads, D = qkv.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # [B, heads, N, D]
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = (s.view(B, heads, N, KH, KW) + rel_h[..., :, None]
         + rel_w[..., None, :]).view(B, heads, N, N)
    out = torch.softmax(s, -1).to(v.dtype) @ v
    return out.transpose(1, 2)  # [B, N, heads, D]


def relpos_attention(qkv: torch.Tensor, rel_h: torch.Tensor,
                     rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernels K7/K8 for CUDA tensors, the plain version for CPU tensors;
    differentiable in qkv, rel_h and rel_w."""
    if qkv.is_cuda:
        from .cuda_attention import relpos_attention_cuda

        return relpos_attention_cuda(qkv, rel_h, rel_w, scale)
    return relpos_attention_plain(qkv, rel_h, rel_w, scale)
