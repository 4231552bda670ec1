"""The builder of the configurations with "family": "VITDET": DG Faster
R-CNN on ViTDet-B (Li et al., arXiv:2203.16527), sized by the
configuration's `vit` and `frcnn` groups. The program's model is the
port's own DGFRCNNModel(backbone="vitdet_b"); the reference's is
perfbench/reference/models/vitdet.py's. Everything downstream of the
pyramid, the draws and the kernels included, is the FRCNN builder's; the
draws add the drop-path uniforms, the kernels K7 and K8.

The check's proposals: the program's RPN scores of a random ViT are near
ties, so rounding alone picks other proposals, and with them other sampled
RoIs, on the two sides, and the readings of the box head and of every
leaf it reaches move as far as the fp8 control's (PERF.md, section 4).
So the builder records the proposals of the program's first TAPED
training forwards (the check's three pairs, two halves each) as they
are, and each reference model it builds follows them
(reference/models/vitdet.py::DGFRCNNModel.follow_proposals). Proposals
take no gradient; what the check compares is then the same computation on
both sides. The recording leaves the program's arithmetic as it is and
ends after TAPED forwards.

Found by perfbench/bench/common.py::builder from the configuration's
family; what it gives is listed in PERF.md, section 4."""

from __future__ import annotations

import torch

from perfbench.bench import build, common, flops_vitdet

FRCNN = common.builder({"family": "FRCNN"})
RESNET = [1, 1, 1, 1]  # FRCNN's ResNet sizes, unused under a ViT
TAPED = 6  # the program's training forwards whose proposals are recorded
_tape: list = []  # (boxes, valid) of each, the last program model's


def _kwargs(config: dict, frcnn_config_cls, compute_dtype) -> dict:
    """DGFRCNNModel's arguments as the FRCNN builder gives them."""
    kw = FRCNN._kwargs(dict(config, backbone_block_counts=RESNET),
                       frcnn_config_cls, compute_dtype)
    del kw["backbone_block_counts"]
    return kw


def program_model(config: dict, device, compute_dtype):
    from dgod_tpu_torch.models import dg_frcnn, faster_rcnn
    from dgod_tpu_torch.models.vitdet import ViTDetConfig

    model = dg_frcnn.DGFRCNNModel(
        device=device, backbone="vitdet_b",
        vit=ViTDetConfig.of(config["vit"]),
        **_kwargs(config, faster_rcnn.FRCNNConfig, compute_dtype))
    _record_proposals(model.detector)
    return model


def _record_proposals(detector) -> None:
    """Record into `_tape` the proposals of the detector's next TAPED
    training forwards, then give it back its own method."""
    _tape.clear()
    own = detector.generate_proposals

    def generate_proposals(objectness, deltas, image_sizes, training):
        out = own(objectness, deltas, image_sizes, training)
        if training:
            _tape.append((out[0].clone(), out[1].clone()))
            if len(_tape) == TAPED:
                del detector.generate_proposals
        return out

    detector.generate_proposals = generate_proposals


def reference_model(config: dict, device, compute_dtype, fp8: bool):
    from perfbench.reference.models import faster_rcnn, layers, vitdet

    model = vitdet.DGFRCNNModel(
        config["vit"], device=device,
        **_kwargs(config, faster_rcnn.FRCNNConfig, compute_dtype))
    if fp8:
        build.fp8_control(model, (layers.Conv, layers.Dense))
    model.follow_proposals(list(_tape))
    return model


def draw_maker(config: dict, batch: int, max_gt: int, device, seed: int):
    """-> draws(with_rpn): the FRCNN builder's sampling priorities of one
    loss evaluation, in its order and from its generator, then the
    drop-path uniforms [batch, depth, 2] from the same generator, a
    5-tuple."""
    from perfbench.bench import kernels

    counts = kernels.frcnn_anchor_counts(tuple(config["canvas"]))
    f = config["frcnn"]
    n_prop = min(f["rpn_post_nms_train"],
                 sum(min(f["rpn_pre_nms_train"], c) for c in counts))
    depth = config["vit"]["depth"]
    gen = torch.Generator(device=device).manual_seed(2 * seed + 1)

    def uniform(*shape):
        return torch.rand((batch, *shape), generator=gen, device=device)

    def draws(with_rpn):
        rpn = ((uniform(sum(counts)), uniform(sum(counts))) if with_rpn
               else (None, None))
        return (*rpn, uniform(n_prop + max_gt), uniform(n_prop + max_gt),
                uniform(depth, 2))

    return draws


def wrap_draws(side: str):
    """draws -> the `side` model's Draws, the drop-path uniforms last."""
    if side == "program":
        from dgod_tpu_torch.models.dg_frcnn import Draws
    else:
        from perfbench.reference.models.vitdet import Draws
    return lambda d: Draws(*d)


train_flops_per_image = flops_vitdet.train_flops_per_image
predict_flops_per_image = flops_vitdet.predict_flops_per_image


def kernels_on(path: str, config: dict) -> dict:
    """The FRCNN builder's kernels on the path, and K7 (every forward) and
    K8 (every backward, training only) at their window and global shapes:
    the blocks of each kind, heads, head width, tokens and grid of an
    attention, and the windows per image."""
    out = FRCNN.kernels_on(path, config)
    attention = flops_vitdet.attention_shapes(config)
    out["K7"] = attention
    if path == "train":
        out["K8"] = attention
    return out


def tiny(config: dict) -> None:
    """The CPU sizes of perfbench/tests/tiny.py: the FRCNN builder's
    sampling and proposals, and a ViT 32 wide, 4 blocks of 2 heads (1 and
    3 global), windows of 3 tokens (the 4x8 grid padded to 6x9), tables
    for 128 inputs (interpolated)."""
    FRCNN.tiny(config)
    config["vit"].update(embed_dim=32, depth=4, num_heads=2, window_size=3,
                         global_blocks=[1, 3], img_size=128)
