"""Wrappers of kernels K7 (forward) and K8 (backward) in
`csrc/relpos_attention.cu` (CUDA C++, built by `_build.py`), joined in one
`torch.autograd.Function`: ViTDet's attention with decomposed relative
positions, fused. The plain version, and the layouts, are `attention.py`;
the kernels' design (key chunks that are whole rows of the token grid) is
in their source.

The kernels take bf16 qkv [B, N, 3, heads, 64], float32 q R_h and q R_w,
and a token grid of KH x KW = N with KW <= 128.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

fwd_launches = 0  # K7 launches since the last reset (see chip_smoke.py)
bwd_launches = 0  # K8 launches (three kernels each)

HEAD_DIM = 64  # the one head width the kernels are built for
MAX_KW = 128  # the widest grid row they take

_fns = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("relpos_attention"), name)
        pointers = 5 if name == "relpos_attn_fwd" else 10
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(qkv, rel_h, rel_w):
    if not qkv.is_cuda or qkv.dtype != torch.bfloat16 \
            or not qkv.is_contiguous() or qkv.dim() != 5 \
            or qkv.shape[2] != 3:
        raise ValueError(f"relpos_attention_cuda: qkv must be a contiguous "
                         f"bf16 [B, N, 3, heads, D] on a CUDA device, got "
                         f"{qkv.dtype} {tuple(qkv.shape)} on {qkv.device}")
    B, N, _, heads, D = qkv.shape
    if D != HEAD_DIM:
        raise ValueError(f"relpos_attention_cuda: head width {D}; the "
                         f"kernels are built for {HEAD_DIM}")
    for name, t in (("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != qkv.device or t.dim() != 4 \
                or tuple(t.shape[:3]) != (B, heads, N):
            raise ValueError(f"relpos_attention_cuda: {name} must be a "
                             f"contiguous float32 [B, heads, N, K] on qkv's "
                             f"device, got {t.dtype} {tuple(t.shape)}")
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if KH * KW != N:
        raise ValueError(f"relpos_attention_cuda: a {KH} x {KW} grid does "
                         f"not hold {N} tokens")
    if KW > MAX_KW:
        raise ValueError(f"relpos_attention_cuda: a grid {KW} wide; the "
                         f"kernels take at most {MAX_KW}")
    return B, N, heads, KH, KW


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def relpos_attention_fwd_cuda(qkv, rel_h, rel_w, scale: float):
    """K7: -> (out [B, N, heads, D] bf16, the log-sum-exp of each row in
    base 2 [B, heads, N] float32)."""
    global fwd_launches
    B, N, heads, KH, KW = _check(qkv, rel_h, rel_w)
    out = torch.empty((B, N, heads, HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    lse = torch.empty((B, heads, N), dtype=torch.float32, device=qkv.device)
    rc = _kernel("relpos_attn_fwd")(
        qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, N, heads, KH, KW, scale, _stream(qkv))
    _build.check_launch(rc, "relpos_attn_fwd")
    fwd_launches += 1
    return out, lse


def relpos_attention_bwd_cuda(qkv, rel_h, rel_w, out, lse, grad_out,
                              scale: float):
    """K8: -> (d qkv [B, N, 3, heads, D] bf16, d rel_h, d rel_w float32)."""
    global bwd_launches
    B, N, heads, KH, KW = _check(qkv, rel_h, rel_w)
    grad_out = grad_out.to(qkv.dtype).contiguous()
    out = out.contiguous()
    delta = torch.empty_like(lse)
    dqkv = torch.empty_like(qkv)
    drh, drw = torch.empty_like(rel_h), torch.empty_like(rel_w)
    rc = _kernel("relpos_attn_bwd")(
        qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
        grad_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dqkv.data_ptr(), drh.data_ptr(), drw.data_ptr(), B, N, heads, KH, KW,
        scale, _stream(qkv))
    _build.check_launch(rc, "relpos_attn_bwd")
    bwd_launches += 1
    return dqkv, drh, drw


class RelPosAttentionFunction(torch.autograd.Function):
    """K7 forward, K8 backward."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, scale):
        out, lse = relpos_attention_fwd_cuda(qkv, rel_h, rel_w, scale)
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dqkv, drh, drw = relpos_attention_bwd_cuda(
            qkv, rel_h, rel_w, out, lse, grad_out, ctx.scale)
        return dqkv, drh, drw, None


def relpos_attention_cuda(qkv, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The attention of `attention.py` on the card, differentiable in qkv,
    rel_h and rel_w."""
    return RelPosAttentionFunction.apply(qkv, rel_h, rel_w, scale)
