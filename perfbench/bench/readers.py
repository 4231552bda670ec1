"""Arithmetic that several per-layer metrics share, over run.Context."""

from __future__ import annotations

from . import common


def train_flops_per_image(ctx) -> float:
    """Model FLOPs per trained image of a DG cycle, at the cycle's own
    sizes, as the configuration's builder counts them."""
    return common.builder(ctx.config).train_flops_per_image(ctx.config,
                                                            ctx.s.batch)


def predict_flops_per_image(ctx) -> float:
    """Model FLOPs of one image's forward at predict, as the
    configuration's builder counts them."""
    return common.builder(ctx.config).predict_flops_per_image(ctx.config)


def mfu_percent(ctx, flops_per_image: float) -> float:
    w = ctx.window
    return (100.0 * w["images"] / w["seconds"] * flops_per_image
            / ctx.kernels.BF16_PEAK_FLOPS)


def kernel_roofline_percent(ctx):
    """Sum of the port's kernels' bounds over their launches in the
    profiled sub-window, over the device time of those kernels there, in
    %; None where none of them ran."""
    device_s = ctx.profile.kernel_s()
    device_s.pop(None, None)
    total_s = sum(device_s.values())
    if total_s <= 0:
        return None
    bound = sum(n * ctx.kernels.bound_s(k, ctx.path, ctx.config,
                                        ctx.s.batch, ctx.s.max_gt)
                for k, n in ctx.launches.items() if n)
    return 100.0 * bound / total_s


def per_unit_ms(ctx, seconds: float) -> float:
    return 1e3 * seconds / ctx.profile.units
