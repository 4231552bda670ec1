"""The builder of the configurations with "family": "FRCNN": DG Faster R-CNN
on ResNet-50 FPN (DGFRCNNModel of dgod_tpu_torch and of the reference),
sized by the configuration's `frcnn` group and `backbone_block_counts`.

Found by perfbench/bench/common.py::builder from the configuration's
family; what it gives is listed in PERF.md, section 4."""

from __future__ import annotations

import torch

from perfbench.bench import build, flops, kernels


def _kwargs(config: dict, frcnn_config_cls, compute_dtype) -> dict:
    """Constructor arguments of DGFRCNNModel, its FRCNNConfig of class
    `frcnn_config_cls` (the program's or the reference's)."""
    frcnn = dict(config["frcnn"])
    frcnn["box_reg_weights"] = tuple(frcnn["box_reg_weights"])
    return dict(num_classes=config["num_classes"],
                num_domains=config["num_domains"],
                canvas=tuple(config["canvas"]), compute_dtype=compute_dtype,
                backbone_block_counts=tuple(config["backbone_block_counts"]),
                config=frcnn_config_cls(**frcnn))


def program_model(config: dict, device, compute_dtype):
    from dgod_tpu_torch.models import dg_frcnn, faster_rcnn

    return dg_frcnn.DGFRCNNModel(device=device, **_kwargs(
        config, faster_rcnn.FRCNNConfig, compute_dtype))


def reference_model(config: dict, device, compute_dtype, fp8: bool):
    from perfbench.reference.models import dg_frcnn, faster_rcnn, layers

    model = dg_frcnn.DGFRCNNModel(device=device, **_kwargs(
        config, faster_rcnn.FRCNNConfig, compute_dtype))
    if fp8:
        build.fp8_control(model, (layers.Conv, layers.Dense))
    return model


def draw_maker(config: dict, batch: int, max_gt: int, device, seed: int):
    """-> draws(with_rpn): the sampling priorities of one loss evaluation
    (uniform [0, 1) on the card from the benchmark's generator, in the
    order and shapes of DGFRCNNModel.make_draws), a 4-tuple."""
    counts = kernels.frcnn_anchor_counts(tuple(config["canvas"]))
    f = config["frcnn"]
    n_prop = min(f["rpn_post_nms_train"],
                 sum(min(f["rpn_pre_nms_train"], c) for c in counts))
    gen = torch.Generator(device=device).manual_seed(2 * seed + 1)

    def uniform(n):
        return torch.rand((batch, n), generator=gen, device=device)

    def draws(with_rpn):
        rpn = ((uniform(sum(counts)), uniform(sum(counts))) if with_rpn
               else (None, None))
        return (*rpn, uniform(n_prop + max_gt), uniform(n_prop + max_gt))

    return draws


def wrap_draws(side: str):
    """draws -> what the `side` ("program" or "reference") model takes: its
    Draws tuple."""
    if side == "program":
        from dgod_tpu_torch.models.dg_frcnn import Draws
    else:
        from perfbench.reference.models.dg_frcnn import Draws
    return lambda d: Draws(*d)


def train_flops_per_image(config: dict, batch: int) -> float:
    """Model FLOPs per trained image of a DG cycle at `batch` (frozen
    cycle_flops), the sampled RoIs' box head included."""
    cyc = flops.cycle_flops("FRCNN", tuple(config["canvas"]), batch,
                            config["num_domains"],
                            config["frcnn"]["box_batch_per_image"],
                            tuple(config["backbone_block_counts"]))
    return cyc["cycle"] / cyc["images_per_cycle"]


def predict_flops_per_image(config: dict) -> float:
    """Model FLOPs of one image's forward at predict, the box head over the
    RPN's rpn_post_nms_test RoIs."""
    fw = flops.family_forward_flops("FRCNN", tuple(config["canvas"]),
                                    config["frcnn"]["rpn_post_nms_test"],
                                    tuple(config["backbone_block_counts"]))
    return fw["frozen"] + fw["trunk"] + fw["head"]


def kernels_on(path: str, config: dict) -> dict:
    """The port's kernels that the `path` ('train' or 'predict') may
    launch, each with the sizes of its inputs per image (the work(sizes,
    batch, max_gt) of perfbench/kernels/<id>.py): RoIAlign pools the
    sampled RoIs (training) or the RPN's proposals (predict) from P2-P5, K3
    matches every anchor, K5 decodes each level's top-k, K6 ranks every
    class at each proposal."""
    canvas = tuple(config["canvas"])
    f = config["frcnn"]
    train = path == "train"
    anchors = kernels.frcnn_anchor_counts(canvas)
    top = f["rpn_pre_nms_train"] if train else f["rpn_pre_nms_test"]
    pool = dict(rois=f["box_batch_per_image"] if train
                else f["rpn_post_nms_test"], channels=kernels.FPN_CHANNELS)
    return {"K1": pool,
            "K2": dict(pool, levels=kernels.level_sizes(
                canvas, kernels.ROI_STRIDES)),
            "K3": {"locations": sum(anchors)},
            "K5": {"entries": sum(min(top, n) for n in anchors)},
            "K6": {"candidates": f["rpn_post_nms_test"]
                   * config["num_classes"],
                   "picks": f["detections_per_img"]}}


def tiny(config: dict) -> None:
    """The CPU sizes of perfbench/tests/tiny.py: ResNet blocks (1,1,1,1),
    sampling and proposals as the port's CPU tests size them."""
    config["backbone_block_counts"] = [1, 1, 1, 1]
    config["frcnn"].update(rpn_pre_nms_train=256, rpn_pre_nms_test=256,
                           rpn_post_nms_train=256, rpn_post_nms_test=32,
                           rpn_batch_per_image=64, box_batch_per_image=64)
