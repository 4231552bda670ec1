"""The traced window's model FLOPs (frozen cycle_flops) per second over the
H100 SXM's dense bf16 peak, in %."""

from perfbench.bench import readers


def read(ctx):
    if ctx.path != "train":
        return None
    return readers.mfu_percent(ctx, readers.train_flops_per_image(ctx))
