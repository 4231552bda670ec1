"""The share of the optimizer's leaf updates that one multi-tensor kernel
(K9) made over the run, in %: fused / (fused + plain), from the program's
own counters (dgod_tpu_torch/train/optim.py). None where the program has
no such counters."""

import importlib


def read(ctx):
    if ctx.path != "train":
        return None
    try:
        optim = importlib.import_module("dgod_tpu_torch.train.optim")
    except ImportError:
        return None
    fused = getattr(optim, "fused_leaves", None)
    plain = getattr(optim, "plain_leaves", None)
    if fused is None or plain is None or fused + plain == 0:
        return None
    return 100.0 * fused / (fused + plain)
