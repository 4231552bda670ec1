"""Arithmetic that several per-layer metrics share, over run.Context."""

from __future__ import annotations


def train_flops_per_image(ctx) -> float:
    """Model FLOPs per trained image of a DG cycle (frozen copy of
    utils/flops.py::cycle_flops), at the cycle's own sizes."""
    c = ctx.config
    rois = c["frcnn"]["box_batch_per_image"] if c["family"] == "FRCNN" \
        else 512
    cyc = ctx.flops.cycle_flops(c["family"], tuple(c["canvas"]),
                                ctx.s.batch, c["num_domains"], rois,
                                tuple(c["backbone_block_counts"]))
    return cyc["cycle"] / cyc["images_per_cycle"]


def predict_flops_per_image(ctx) -> float:
    """Model FLOPs of one image's forward at predict (the RPN's
    rpn_post_nms_test RoIs for FRCNN)."""
    c = ctx.config
    rois = c["frcnn"]["rpn_post_nms_test"] if c["family"] == "FRCNN" else 0
    fw = ctx.flops.family_forward_flops(c["family"], tuple(c["canvas"]),
                                        rois,
                                        tuple(c["backbone_block_counts"]))
    return fw["frozen"] + fw["trunk"] + fw["head"]


def mfu_percent(ctx, flops_per_image: float) -> float:
    w = ctx.window
    return (100.0 * w["images"] / w["seconds"] * flops_per_image
            / ctx.kernels.BF16_PEAK_FLOPS)


def kernel_roofline_percent(ctx):
    """Sum of the port's kernels' bounds over their launches in the
    profiled sub-window, over the device time of those kernels there, in
    %; None where none of them ran."""
    device_s = ctx.profile.device_s_by(ctx.kernels.kernel_id)
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
