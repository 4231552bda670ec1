"""The port's kernels' bound over their device time in the profiled
requests, in % (bench/kernels.py)."""

from perfbench.bench import readers


def read(ctx):
    return readers.kernel_roofline_percent(ctx) if ctx.path == "predict" \
        else None
