"""The port's table of kernel categories: a profiler kernel name ->
the category its device time is counted in, the first pattern that
matches winning.

To see where a DG cycle's or a request's time goes on the card, run
`python3 perfbench/run.py --workload <cell> --seed <n> --seconds 50
--trace 1` (device time by category, idle share, and the launches, host
syncs and device-idle time of each layer of the program's `dgod.*`
spans); `dgod_tpu_torch/utils/logging.py::profile_steps` records an
operator's own trace with those spans. The table keeps this file's name
because perfbench/tests/test_perfbench_frozen.py holds the benchmark's
frozen copy (perfbench/bench/kernels.py::CATEGORIES) to it.
"""

# kernel name -> category, first match wins; K2's pattern also takes the
# names of its earlier atomic design (bwd_kernel, cast_bf16_kernel), so that
# an older checkout profiles into the same categories
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
