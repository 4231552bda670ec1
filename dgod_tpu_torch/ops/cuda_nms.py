"""Wrapper of kernel K6 (`csrc/nms_topk.cu`): greedy NMS cut after the
first k picks, batched over images.

Replaces dgod_tpu/ops/pallas_nms.py::_nms_kernel (via nms_topk_pallas). One
block per image runs the k argmax-and-suppress rounds with the image's live
scores (and boxes, where they fit) in shared memory. Bound on the H100 by
the serial dependency of the rounds, not by bytes or operations; see the
source for the design. The plain version is `nms.nms_topk_plain`; idx and ok
must agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see chip_smoke.py)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("nms_topk").nms_topk
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_float] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def nms_topk_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float, k: int):
    """boxes [B,K,4] f32, scores [B,K] f32, valid [B,K] bool, all contiguous
    on one CUDA device -> (idx [B,k] int64, ok [B,k] bool)."""
    global launches
    for name, t in (("boxes", boxes), ("scores", scores), ("valid", valid)):
        if not t.is_cuda or t.device != boxes.device:
            raise ValueError(f"nms_topk_cuda: {name} must be on the CUDA "
                             f"device of boxes, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"nms_topk_cuda: {name} must be contiguous")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms_topk_cuda: boxes and scores must be float32")
    if valid.dtype != torch.bool:
        raise TypeError("nms_topk_cuda: valid must be bool")
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms_topk_cuda: boxes must be [B,K,4], got "
                         f"{tuple(boxes.shape)}")
    B, K = boxes.shape[:2]
    if tuple(scores.shape) != (B, K) or tuple(valid.shape) != (B, K):
        raise ValueError("nms_topk_cuda: scores and valid must be [B,K]")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_topk_cuda: boxes must be 16-byte aligned")

    idx = torch.empty((B, k), dtype=torch.int64, device=boxes.device)
    ok = torch.empty((B, k), dtype=torch.bool, device=boxes.device)
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), B, K,
                int(k), float(iou_threshold), idx.data_ptr(), ok.data_ptr(),
                stream)
    _build.check_launch(rc, "nms_topk")
    launches += 1
    return idx, ok
