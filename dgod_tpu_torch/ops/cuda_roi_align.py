"""Wrappers of kernels K1 (forward) and K2 (backward) in
`csrc/roi_align.cu`, joined in one `torch.autograd.Function`.

K1 replaces dgod_tpu/ops/pallas_roi_align.py::_fwd_kernel/_fwd_kernel_deep
(via _roi_align_fwd); K2 replaces _bwd_kernel/_bwd_kernel_deep (via
_roi_align_bwd). Both are bound by bytes on the H100: K1 writes the f32
pooled features and reads each RoI's window of cells, K2 reads the pooled
gradient and writes the level grads in the feature dtype. In K1 a warp
pools one bin row of a RoI over all channels with 16-byte loads and
streaming stores, a bin's corner loads issued together, while a geometry
warp prepares the block's next RoI; so K1 takes levels and RoIs that are
16-byte aligned, with C * itemsize a multiple of 16. K2 is
output-stationary where the TPU kernel serialised aliasing RoI windows:
one pass stores each RoI's sample geometry and the masks of the 8x8-cell
tiles it touches, a second gives each (image, level, tile) one block that
sums its RoIs' contributions over 256 channels in shared memory, in
ascending RoI order, and writes the tile once in the feature dtype. No f32 buffer, memset, cast pass or atomics; two calls on
the same inputs give the same bits. The RoI gradient is zero, as in the
TPU kernel's VJP. The plain version is `roi_align.roi_align_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .roi_align import STRIDES

fwd_launches = 0  # K1 launches since the last reset (see chip_smoke.py)
bwd_launches = 0  # K2 launches

_fns = {}


def _kernels():
    if not _fns:
        lib = _build.load("roi_align")
        fwd = lib.roi_align_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 2
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.roi_align_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                        + [ctypes.c_float] * 4 + [ctypes.c_void_p]
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        scratch = lib.roi_align_bwd_scratch
        scratch.argtypes = [ctypes.c_int]
        scratch.restype = ctypes.c_longlong
        _fns.update(fwd=fwd, bwd=bwd, scratch=scratch)
    return _fns


def _check(feats: Sequence[torch.Tensor], rois: torch.Tensor):
    if len(feats) != 4:
        raise ValueError("roi_align_cuda: takes P2..P5 at strides 4/8/16/32")
    if not rois.is_cuda or rois.dtype != torch.float32 \
            or not rois.is_contiguous():
        raise ValueError("roi_align_cuda: rois must be contiguous float32 on "
                         "a CUDA device")
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"roi_align_cuda: rois must be [B,N,4], got "
                         f"{tuple(rois.shape)}")
    B = rois.shape[0]
    C = feats[0].shape[-1]
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align_cuda: features must be float32 or "
                        f"bfloat16, got {dtype}")
    for f in feats:
        if f.device != rois.device or f.dtype != dtype:
            raise ValueError("roi_align_cuda: every level must share the "
                             "rois' device and one dtype")
        if f.dim() != 4 or f.shape[0] != B or f.shape[-1] != C:
            raise ValueError(f"roi_align_cuda: a level must be [B,H,W,C], "
                             f"got {tuple(f.shape)}")
        if not f.is_contiguous():
            raise ValueError("roi_align_cuda: levels must be contiguous NHWC")


def _dims(feats):
    dims = []
    for f in feats:
        dims += [f.shape[1], f.shape[2]]
    return dims + [1.0 / s for s in STRIDES]


def roi_align_fwd_cuda(feats, rois) -> torch.Tensor:
    """K1: feats 4x [B,H,W,C] NHWC, rois [B,N,4] -> pooled [B,N,7,7,C] f32."""
    global fwd_launches
    _check(feats, rois)
    B, N = rois.shape[:2]
    C = feats[0].shape[-1]
    if C * feats[0].element_size() % 16:
        raise ValueError(f"roi_align_fwd_cuda: C * itemsize must be a "
                         f"multiple of 16 bytes, got C={C}")
    if any(t.data_ptr() % 16 for t in (rois, *feats)):
        raise ValueError("roi_align_fwd_cuda: levels and rois must be "
                         "16-byte aligned")
    out = torch.empty((B, N, 7, 7, C), dtype=torch.float32,
                      device=rois.device)
    fwd = _kernels()["fwd"]
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    rc = fwd(*[f.data_ptr() for f in feats], *_dims(feats),
             rois.data_ptr(), out.data_ptr(), B, N, C,
             int(feats[0].dtype == torch.bfloat16), stream)
    _build.check_launch(rc, "roi_align_fwd")
    fwd_launches += 1
    return out


def roi_align_bwd_cuda(feats, rois, grad_out):
    """K2: grad_out [B,N,7,7,C] f32 -> per-level grads [B,H,W,C] in the
    feature dtype (each cell summed in f32 in a fixed order, rounded
    once)."""
    global bwd_launches
    _check(feats, rois)
    B, N = rois.shape[:2]
    C = feats[0].shape[-1]
    if grad_out.dtype != torch.float32 or tuple(grad_out.shape) != (
            B, N, 7, 7, C) or grad_out.device != rois.device:
        raise ValueError("roi_align_bwd_cuda: grad must be [B,N,7,7,C] f32 "
                         "on the rois' device")
    grad_out = grad_out.contiguous()
    sizes = [f.numel() for f in feats]
    # the kernel writes every element of `out`; `scratch` holds the RoIs'
    # geometry and tile masks
    out = torch.empty(sum(sizes), dtype=feats[0].dtype, device=rois.device)
    fns = _kernels()
    scratch = torch.empty(fns["scratch"](B * N), dtype=torch.uint8,
                          device=rois.device)
    is_bf16 = feats[0].dtype == torch.bfloat16
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    rc = fns["bwd"](grad_out.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                    *_dims(feats), rois.data_ptr(), B, N, C, int(is_bf16),
                    stream)
    _build.check_launch(rc, "roi_align_bwd")
    bwd_launches += 1
    return [g.view(f.shape) for g, f in zip(out.split(sizes), feats)]


class RoIAlignFunction(torch.autograd.Function):
    """K1 forward, K2 backward; the RoIs get no gradient."""

    @staticmethod
    def forward(ctx, rois, *feats):
        ctx.save_for_backward(rois, *feats)
        return roi_align_fwd_cuda(feats, rois)

    @staticmethod
    def backward(ctx, grad_out):
        rois, *feats = ctx.saved_tensors
        return (None, *roi_align_bwd_cuda(feats, rois, grad_out.float()))


def roi_align_cuda(feats: Sequence[torch.Tensor],
                   rois: torch.Tensor) -> torch.Tensor:
    """Multi-scale RoIAlign on the card over P2..P5 (strides 4/8/16/32),
    differentiable in the features."""
    return RoIAlignFunction.apply(rois, *feats)
