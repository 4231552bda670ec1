"""The window's forward model FLOPs per second (frozen
family_forward_flops) over the H100 SXM's dense bf16 peak, in %."""

from perfbench.bench import readers


def read(ctx):
    if ctx.path != "predict":
        return None
    return readers.mfu_percent(ctx, readers.predict_flops_per_image(ctx))
