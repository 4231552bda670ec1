"""Wrapper of kernel K5 (`csrc/proposals.cu`): RPN proposal decode + clip +
small-box mask + exact greedy NMS over every (image, level) in one call.

Replaces dgod_tpu/ops/pallas_proposals.py::_kernel (via fused_decode_nms).
Three launches on the current stream, no host sync: decode; the IoU
bitmask over each level's upper triangle only; and a scan that decides 64
rows per step, one block per (image, level), so it waits on global memory
about twice per 64 rows instead of once per kept row. Bound on the H100 by
operations: ~14 f32 ops per IoU of a kept box with a later valid box of
its level; the serial scan is not in the bound. See the source for the
design. The plain version is
`proposals.decode_nms_plain`; the keep mask must agree exactly and the
boxes to rounding (they are expected to be bit-equal).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see chip_smoke.py)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("proposals").decode_nms
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_float, ctypes.c_float]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def mask_words(level_sizes: Sequence[int]) -> int:
    """64-bit IoU mask words one image needs: each level's rows times its
    64-column words."""
    return sum(int(n) * ((int(n) + 63) // 64) for n in level_sizes)


def decode_nms_cuda(deltas: torch.Tensor, anchors: torch.Tensor,
                    sizes: torch.Tensor, level_sizes: Sequence[int],
                    iou_threshold: float, min_size: float = 1e-3):
    """deltas, anchors [B,K,4] f32 and sizes [B,2] f32, contiguous on one
    CUDA device, each level's entries in rank order -> (boxes [B,K,4] f32,
    keep [B,K] bool)."""
    global launches
    for name, t in (("deltas", deltas), ("anchors", anchors),
                    ("sizes", sizes)):
        if not t.is_cuda or t.device != deltas.device:
            raise ValueError(f"decode_nms_cuda: {name} must be on the CUDA "
                             f"device of deltas, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_nms_cuda: {name} must be contiguous")
        if t.dtype != torch.float32:
            raise TypeError(f"decode_nms_cuda: {name} must be float32")
    if deltas.dim() != 3 or deltas.shape[-1] != 4:
        raise ValueError(f"decode_nms_cuda: deltas must be [B,K,4], got "
                         f"{tuple(deltas.shape)}")
    B, K = deltas.shape[:2]
    if tuple(anchors.shape) != (B, K, 4) or tuple(sizes.shape) != (B, 2):
        raise ValueError("decode_nms_cuda: anchors must be [B,K,4] and "
                         "sizes [B,2]")
    sizes_list = [int(n) for n in level_sizes]
    if any(n < 0 for n in sizes_list) or sum(sizes_list) != K:
        raise ValueError(f"decode_nms_cuda: level sizes {sizes_list} must "
                         f"be >= 0 and sum to K={K}")
    if deltas.data_ptr() % 16 or anchors.data_ptr() % 16 \
            or sizes.data_ptr() % 8:
        raise ValueError("decode_nms_cuda: deltas and anchors must be "
                         "16-byte aligned, sizes 8-byte aligned")

    starts = [0]
    for n in sizes_list:
        starts.append(starts[-1] + n)
    level_start = (ctypes.c_int * len(starts))(*starts)
    dev = deltas.device
    boxes = torch.empty((B, K, 4), dtype=torch.float32, device=dev)
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    valid = torch.empty((B, K), dtype=torch.uint8, device=dev)
    mask = torch.empty((max(1, B * mask_words(sizes_list)),),
                       dtype=torch.int64, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(deltas.data_ptr(), anchors.data_ptr(), sizes.data_ptr(), B, K,
                level_start, len(sizes_list), float(iou_threshold),
                float(min_size), boxes.data_ptr(), keep.data_ptr(),
                valid.data_ptr(), mask.data_ptr(), stream)
    _build.check_launch(rc, "decode_nms")
    launches += 1
    return boxes, keep
