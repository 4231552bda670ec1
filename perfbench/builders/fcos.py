"""The builder of the configurations with "family": "FCOS": DG FCOS on
ResNet-50 FPN (DGFCOSModel of dgod_tpu_torch and of the reference), sized
by the configuration's `fcos_loss` and `fcos` groups and
`backbone_block_counts`.

Found by perfbench/bench/common.py::builder from the configuration's
family; what it gives is listed in PERF.md, section 4."""

from __future__ import annotations

from perfbench.bench import build, flops, kernels

# the RoIs per image that the frozen cycle_flops takes; FCOS pools none
TRAIN_ROIS = 512


def _kwargs(config: dict, loss_config_cls, compute_dtype) -> dict:
    """Constructor arguments of DGFCOSModel, its FCOSLossConfig of class
    `loss_config_cls` (the program's or the reference's)."""
    return dict(num_classes=config["num_classes"],
                num_domains=config["num_domains"],
                canvas=tuple(config["canvas"]), compute_dtype=compute_dtype,
                backbone_block_counts=tuple(config["backbone_block_counts"]),
                loss_config=loss_config_cls(**config["fcos_loss"]))


def program_model(config: dict, device, compute_dtype):
    from dgod_tpu_torch.models import dg_fcos, fcos

    return dg_fcos.DGFCOSModel(device=device, **_kwargs(
        config, fcos.FCOSLossConfig, compute_dtype))


def reference_model(config: dict, device, compute_dtype, fp8: bool):
    from perfbench.reference.models import dg_fcos, fcos, layers

    model = dg_fcos.DGFCOSModel(device=device, **_kwargs(
        config, fcos.FCOSLossConfig, compute_dtype))
    if fp8:
        build.fp8_control(model, (layers.Conv, layers.Dense))
    return model


def draw_maker(config: dict, batch: int, max_gt: int, device, seed: int):
    """FCOS samples nothing: every loss evaluation's draws are None."""
    return lambda with_rpn: None


def wrap_draws(side: str):
    return lambda d: d


def train_flops_per_image(config: dict, batch: int) -> float:
    """Model FLOPs per trained image of a DG cycle at `batch` (frozen
    cycle_flops)."""
    cyc = flops.cycle_flops("FCOS", tuple(config["canvas"]), batch,
                            config["num_domains"], TRAIN_ROIS,
                            tuple(config["backbone_block_counts"]))
    return cyc["cycle"] / cyc["images_per_cycle"]


def predict_flops_per_image(config: dict) -> float:
    """Model FLOPs of one image's forward at predict."""
    fw = flops.family_forward_flops("FCOS", tuple(config["canvas"]), 0,
                                    tuple(config["backbone_block_counts"]))
    return fw["frozen"] + fw["trunk"] + fw["head"]


def kernels_on(path: str, config: dict) -> dict:
    """The port's kernels that the `path` may launch, with the sizes of
    their inputs per image: K4 matches every FCOS location, K6 ranks each
    level's top candidates."""
    counts = kernels.fcos_anchor_counts(tuple(config["canvas"]))
    f = config["fcos"]
    return {"K4": {"locations": sum(counts)},
            "K6": {"candidates": sum(min(f["topk_candidates"], n)
                                     for n in counts),
                   "picks": f["detections_per_img"]}}


def tiny(config: dict) -> None:
    """The CPU sizes of perfbench/tests/tiny.py: ResNet blocks (1,1,1,1)."""
    config["backbone_block_counts"] = [1, 1, 1, 1]
