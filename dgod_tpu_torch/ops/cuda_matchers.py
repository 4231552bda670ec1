"""Wrappers of the matcher kernels; codes must equal the plain versions'.

- K3 (`csrc/iou_match.cu`, `iou_match_cuda`): the batched RPN IoU matcher.
  Replaces dgod_tpu/ops/pallas_matchers.py::_iou_match_kernel (via
  iou_match_tpu). Bound on the H100 by operations: ~20 f32 ops and one IEEE
  division per (image, valid gt, anchor) IoU, never materialising the
  [B,G,R] planes. Anchors on the thread axis over each image's valid gt,
  compacted in shared memory; pass 1 stores each anchor's max IoU and
  argmax and each gt's best, pass 2 codes each anchor and tests the
  low-quality rescue only against the gt whose best can tie. Plain version:
  `matchers.match_anchors_plain`.
- K4 (`csrc/fcos_match.cu`, `fcos_match_cuda`): the FCOS centre-sampling
  matcher. Replaces dgod_tpu/ops/pallas_matchers.py::_fcos_match_kernel (via
  fcos_match_tpu). One thread per anchor; each block compacts its image's
  valid gt in ascending index into shared memory, and its threads walk
  that list. Each thread derives its anchor's planes (centre, radius, level
  range) as the plain version `matchers.fcos_match` does. A fused FCOS
  pair step launches it once (`DGFCOSModel.pair_targets`).

See the sources for the designs.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (see chip_smoke.py)
launches = 0  # K3
fcos_launches = 0  # K4

_fn = None
_fcos_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("iou_match").iou_match
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def iou_match_cuda(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   anchors: torch.Tensor, high_threshold: float,
                   low_threshold: float, allow_low_quality_matches: bool
                   ) -> torch.Tensor:
    """gt_boxes [B,G,4] f32, gt_valid [B,G] bool, anchors [R,4] f32, all
    contiguous on one CUDA device -> matches [B,R] int32."""
    global launches
    for name, t in (("gt_boxes", gt_boxes), ("gt_valid", gt_valid),
                    ("anchors", anchors)):
        if not t.is_cuda or t.device != gt_boxes.device:
            raise ValueError(f"iou_match_cuda: {name} must be on the CUDA "
                             f"device of gt_boxes, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"iou_match_cuda: {name} must be contiguous")
    if gt_boxes.dtype != torch.float32 or anchors.dtype != torch.float32:
        raise TypeError("iou_match_cuda: boxes and anchors must be float32")
    if gt_valid.dtype != torch.bool:
        raise TypeError("iou_match_cuda: gt_valid must be bool")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(f"iou_match_cuda: gt_boxes must be [B,G,4], got "
                         f"{tuple(gt_boxes.shape)}")
    B, G = gt_boxes.shape[:2]
    if tuple(gt_valid.shape) != (B, G):
        raise ValueError("iou_match_cuda: gt_valid must be [B,G]")
    if anchors.dim() != 2 or anchors.shape[-1] != 4:
        raise ValueError("iou_match_cuda: anchors must be [R,4]")
    if gt_boxes.data_ptr() % 16 or anchors.data_ptr() % 16:
        raise ValueError("iou_match_cuda: boxes must be 16-byte aligned")
    R = anchors.shape[0]

    # scratch: each gt's best IoU, each anchor's max IoU and argmax
    best = torch.empty((B, G), dtype=torch.int32, device=gt_boxes.device)
    top = torch.empty((B, R, 2), dtype=torch.int32, device=gt_boxes.device)
    out = torch.empty((B, R), dtype=torch.int32, device=gt_boxes.device)
    fn = _kernel()
    stream = torch.cuda.current_stream(gt_boxes.device).cuda_stream
    rc = fn(gt_boxes.data_ptr(), gt_valid.data_ptr(), anchors.data_ptr(),
            best.data_ptr(), top.data_ptr(), out.data_ptr(), B, G, R,
            float(high_threshold), float(low_threshold),
            int(bool(allow_low_quality_matches)), stream)
    _build.check_launch(rc, "iou_match")
    launches += 1
    return out


def _fcos_kernel():
    global _fcos_fn
    if _fcos_fn is None:
        fn = _build.load("fcos_match").fcos_match
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fcos_fn = fn
    return _fcos_fn


def fcos_match_cuda(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_valid: torch.Tensor, num_anchors_per_level,
                    center_sampling_radius: float = 1.5,
                    exact_reference_area: bool = False) -> torch.Tensor:
    """anchors [R,4] f32, gt_boxes [B,G,4] f32, gt_valid [B,G] bool, all
    contiguous on one CUDA device -> matched [B,R] int32 (kernel K4)."""
    global fcos_launches
    for name, t in (("anchors", anchors), ("gt_boxes", gt_boxes),
                    ("gt_valid", gt_valid)):
        if not t.is_cuda or t.device != gt_boxes.device:
            raise ValueError(f"fcos_match_cuda: {name} must be on the CUDA "
                             f"device of gt_boxes, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"fcos_match_cuda: {name} must be contiguous")
    if gt_boxes.dtype != torch.float32 or anchors.dtype != torch.float32:
        raise TypeError("fcos_match_cuda: boxes and anchors must be float32")
    if gt_valid.dtype != torch.bool:
        raise TypeError("fcos_match_cuda: gt_valid must be bool")
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError(f"fcos_match_cuda: gt_boxes must be [B,G,4], got "
                         f"{tuple(gt_boxes.shape)}")
    B, G = gt_boxes.shape[:2]
    if tuple(gt_valid.shape) != (B, G):
        raise ValueError("fcos_match_cuda: gt_valid must be [B,G]")
    if anchors.dim() != 2 or anchors.shape[-1] != 4:
        raise ValueError("fcos_match_cuda: anchors must be [R,4]")
    if gt_boxes.data_ptr() % 16 or anchors.data_ptr() % 16:
        raise ValueError("fcos_match_cuda: boxes must be 16-byte aligned")
    R = anchors.shape[0]
    counts = [int(c) for c in num_anchors_per_level]
    if sum(counts) != R:
        raise ValueError("fcos_match_cuda: level counts must sum to R")

    out = torch.empty((B, R), dtype=torch.int32, device=gt_boxes.device)
    fn = _fcos_kernel()
    stream = torch.cuda.current_stream(gt_boxes.device).cuda_stream
    rc = fn(gt_boxes.data_ptr(), gt_valid.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), B, G, R, counts[0], counts[-1],
            float(center_sampling_radius), int(bool(exact_reference_area)),
            stream)
    _build.check_launch(rc, "fcos_match")
    fcos_launches += 1
    return out
