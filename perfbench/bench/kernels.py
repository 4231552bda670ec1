"""The yardstick of the device's work: the profiler categories of kernel
names (a frozen copy of scripts/profile_torch_pairs.py's CATEGORIES) and the
work of each of the port's kernels per launch, with the H100 SXM's published
peaks. A kernel's bound is max(bytes / HBM rate, operations / float32 rate).

Each of the port's kernels is a file of its own, perfbench/kernels/<id>.py
(common.kernel_files): the launch counter it reads, the pattern that claims
its device time, and its work per launch from the sizes of its inputs, which
the configuration's builder gives for each path (`kernels_on`). A cell
reads only the files of the kernels its builder lists, so a kernel file
added for a new configuration leaves the other cells' readings as they
were. The launches on the main paths have static shapes, given by the
configuration and the traffic. Each count is what those inputs need, read
once and written once; the terms of chip_smoke.py that depend on the data
(the feature cells a RoI touches, the IoU tests an NMS needs) are left out,
so a bound is never above what the kernel must do, and a share of it never
above 100% for that reason."""

from __future__ import annotations

import functools
import re

from . import common

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
# the rows for kernels outside the port's kernel files, tried after them
GENERIC = tuple((cat, re.compile(p)) for cat, p in CATEGORIES
                if not cat.endswith("(port)"))


@functools.lru_cache(maxsize=None)
def _port(ids) -> tuple:
    """(id, category, compiled pattern) of the kernel files `ids` (a tuple,
    or None for every file), by RANK."""
    return tuple((kid, k.CATEGORY, re.compile(k.PATTERN))
                 for kid, k in common.kernel_files(ids).items())


def category(name: str, ids=None) -> str:
    """The category of the kernel `name`: the first of the kernel files
    `ids` (a cell's, common.cell_kernels; None: every file) whose pattern
    matches it, else the first generic row, else 'other'."""
    for _, cat, pattern in _port(ids):
        if pattern.search(name):
            return cat
    for cat, pattern in GENERIC:
        if pattern.search(name):
            return cat
    return "other"


def kernel_id(name: str, ids=None):
    """The id of the kernel file among `ids` (as in `category`) that
    claims the kernel `name` (e.g. 'K1'), else None."""
    for kid, _, pattern in _port(ids):
        if pattern.search(name):
            return kid
    return None


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
    padded boxes per image: the kernel file's work at the sizes that the
    configuration's builder gives for the path."""
    sizes = common.builder(config).kernels_on(path, config)
    if kid not in sizes:
        raise KeyError(f"{kid} launched on the {path} path, where the "
                       f"builder of {config.get('name')!r} lists "
                       f"{sorted(sizes)}")
    return common.kernel_files((kid,))[kid].work(sizes[kid], batch,
                                                  max_gt)


def bound_s(kid: str, path: str, config: dict, batch: int,
            max_gt: int) -> float:
    """The least time one launch could take on the H100, in seconds."""
    nbytes, ops = launch_work(kid, path, config, batch, max_gt)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS)
