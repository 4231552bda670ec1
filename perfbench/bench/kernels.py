"""The yardstick of the device's work: the profiler categories of kernel
names (a frozen copy of scripts/profile_torch_pairs.py's CATEGORIES) and the
work of each of the port's kernels K1-K6 per launch (the arithmetic of
chip_smoke.py's kernels line), with the H100 SXM's published peaks. A
kernel's bound is max(bytes / HBM rate, operations / float32 rate).

The launches on the main paths have static shapes, given by the
configuration and the traffic: K1 and K2 pool the sampled RoIs (training)
or the RPN's proposals (predict), K3 matches every anchor against the
padded ground truth, K4 every FCOS location, K5 decodes the per-level
top-k, K6 ranks the per-class candidates of a predict. Each count here is
what those inputs need, read once and written once; the terms of
chip_smoke.py that depend on the data (the feature cells a RoI touches,
the IoU tests an NMS needs) are left out, so a bound is never above what
the kernel must do, and a share of it never above 100% for that reason."""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12  # H100 SXM5 HBM3, NVIDIA's datasheet
F32_FLOPS = 67e12  # H100 SXM5 float32 outside the tensor cores
BF16_PEAK_FLOPS = 989.4e12  # dense bf16 tensor-core rate, same datasheet

# kernel name -> category, first match wins (profile_torch_pairs.py)
CATEGORIES = (
    ("K1 roi_align_fwd (port)", r"\bfwd_kernel"),
    ("K2 roi_align_bwd (port)",
     r"bwd_(geometry|gather)_kernel|\bbwd_kernel|cast_bf16_kernel"),
    ("K4 fcos_match (port)", r"fcos_match_kernel"),
    ("K3 iou_match (port)", r"best_kernel|match_kernel|init_best"),
    ("K6 nms_topk (port)", r"nms_topk_kernel"),
    ("K5 decode_nms (port)", r"\b(decode|mask|scan)_kernel\b"),
    ("conv / gemm (cuDNN, cuBLAS)",
     r"gemm|cutlass|xmma|cudnn|conv|wgrad|dgrad|fprop|sm90_|nhwc"),
    ("sort / top-k", r"[Ss]ort|radix|topk|bitonic"),
    ("gather / scatter / index", r"index|gather|scatter|take"),
    ("reduce", r"[Rr]educe"),
    ("elementwise / copy", r"elementwise|vectorized|Memcpy|Memset|copy|fill"),
)
CONV_GEMM = "conv / gemm (cuDNN, cuBLAS)"
ELEMENTWISE = "elementwise / copy"
_COMPILED = tuple((cat, re.compile(p)) for cat, p in CATEGORIES)


def category(name: str) -> str:
    for cat, pattern in _COMPILED:
        if pattern.search(name):
            return cat
    return "other"


def kernel_id(name: str):
    """'K1'..'K6' for a kernel of the port, else None."""
    cat = category(name)
    return cat[:2] if cat.endswith("(port)") else None


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def level_sizes(canvas, strides):
    return [(_ceil_div(canvas[0], s), _ceil_div(canvas[1], s))
            for s in strides]


FRCNN_STRIDES = (4, 8, 16, 32, 64)  # RPN levels P2..P5 and the pool
ROI_STRIDES = (4, 8, 16, 32)  # RoIAlign levels P2..P5
FCOS_STRIDES = (8, 16, 32, 64, 128)
ANCHORS_PER_LOCATION = 3  # aspect ratios 0.5, 1, 2
FPN_CHANNELS = 256


def frcnn_anchor_counts(canvas):
    return [ANCHORS_PER_LOCATION * h * w
            for h, w in level_sizes(canvas, FRCNN_STRIDES)]


def fcos_anchor_counts(canvas):
    return [h * w for h, w in level_sizes(canvas, FCOS_STRIDES)]


def launch_work(kid: str, path: str, config: dict, batch: int,
                max_gt: int) -> tuple:
    """(bytes, float32 operations) of one launch of kernel `kid` on the
    `path` ('train' or 'predict') of `config` at `batch` images and `max_gt`
    padded boxes per image."""
    canvas = tuple(config["canvas"])
    B, G, C = batch, max_gt, FPN_CHANNELS
    if kid in ("K1", "K2"):
        frcnn = config["frcnn"]
        per_image = (frcnn["box_batch_per_image"] if path == "train"
                     else frcnn["rpn_post_nms_test"])
        n_roi = B * per_image
        pooled = n_roi * 49 * C * 4
        ops = n_roi * 49 * 4 * 8 * C  # 4 samples x 4 corners x (mul + add)
        if kid == "K1":
            return pooled + n_roi * 16, ops
        grads = sum(B * h * w * C * 2
                    for h, w in level_sizes(canvas, ROI_STRIDES))
        return pooled + n_roi * 16 + grads, ops
    if kid == "K3":
        R = sum(frcnn_anchor_counts(canvas))
        return B * G * 17 + R * 16 + B * R * 4, 0
    if kid == "K4":
        R = sum(fcos_anchor_counts(canvas))
        return B * G * 17 + R * 16 + B * R * 4, 0
    if kid == "K5":
        frcnn = config["frcnn"]
        top = (frcnn["rpn_pre_nms_train"] if path == "train"
               else frcnn["rpn_pre_nms_test"])
        entries = B * sum(min(top, n) for n in frcnn_anchor_counts(canvas))
        return entries * (16 + 16 + 16 + 1) + B * 8, 30 * entries
    if kid == "K6":
        if config["family"] == "FRCNN":
            frcnn = config["frcnn"]
            K = frcnn["rpn_post_nms_test"] * config["num_classes"]
            k = frcnn["detections_per_img"]
        else:
            top = config["fcos"]["topk_candidates"]
            K = sum(min(top, n) for n in fcos_anchor_counts(canvas))
            k = config["fcos"]["detections_per_img"]
        return B * K * 5 + B * k * 9, 0
    raise ValueError(kid)


def bound_s(kid: str, path: str, config: dict, batch: int,
            max_gt: int) -> float:
    """The least time one launch could take on the H100, in seconds."""
    nbytes, ops = launch_work(kid, path, config, batch, max_gt)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
