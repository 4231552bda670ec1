"""Wrapper of kernel K6 (`csrc/nms_topk.cu`): greedy NMS cut after the
first k picks, batched over images.

Replaces dgod_tpu/ops/pallas_nms.py::_nms_kernel (via nms_topk_pallas). One
block per image walks its live entries in the greedy order (score
descending, the lower index first), a tile at a time: a radix select and a
rank count order each tile in the kernel, a 64x64 IoU bitmask and a serial
scan decide it, and a pool filter drops what a few picks suppress, so the
time follows the picks rather than k x K. The image's live keys sit in
shared memory, 8 bytes per entry: K up to 20,974 entries at k = 100 on the
H100 (`nms_topk_max_entries`; a larger K raises ValueError before the
launch). See the source for the design and the argument that the order
equals the argmax rounds. The plain version is `nms.nms_topk_plain`;
idx and ok must agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see chip_smoke.py)

_fn = None
_max_entries = None


def _kernel():
    global _fn, _max_entries
    if _fn is None:
        lib = _build.load("nms_topk")
        fn = lib.nms_topk
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_float] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _max_entries = lib.nms_topk_max_entries
        _max_entries.argtypes = [ctypes.c_int]
        _max_entries.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_capacity(K: int, k: int, limit: int) -> None:
    """Raise ValueError where K entries per image exceed `limit`, the most
    the kernel's shared memory holds at this k (`nms_topk_max_entries`)."""
    if K > limit:
        raise ValueError(
            f"nms_topk_cuda: {K} entries per image exceed the kernel's limit "
            f"of {limit} at k={k} on this device (its shared memory holds "
            f"8 bytes per live entry); split the candidates or lower K")


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
        check_capacity(K, int(k), _max_entries(int(k)))
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), B, K,
                int(k), float(iou_threshold), idx.data_ptr(), ok.data_ptr(),
                stream)
    _build.check_launch(rc, "nms_topk")
    launches += 1
    return idx, ok
