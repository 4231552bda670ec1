"""Model FLOPs of DG Faster R-CNN on ViTDet-B as bench/flops.py counts a
model's: 2*M*N*K for every product of a convolution, a dense layer or the
attention (q k^T and the weights times v, and q R_h, q R_w of the
decomposed relative positions); normalisations, softmax, GELU and
drop-path do not count. The RPN, box head and DG heads are bench/flops.py's
own, and so is the DG cycle's bookkeeping (cycle_flops), with the whole
ViT and pyramid trainable: forward and backward (3x) in every half of the
cycle but mode 2's, which runs the forward alone."""

from __future__ import annotations

from perfbench.bench import flops


def grid(config: dict) -> tuple:
    """The token grid of the canvas."""
    p = config["vit"]["patch_size"]
    H, W = config["canvas"]
    return H // p, W // p


def attention_shapes(config: dict) -> dict:
    """The attentions of one image's forward: the blocks of each kind, and
    per kind its batch of attentions (windows) per image, tokens, grid;
    heads and head width."""
    v = config["vit"]
    h, w = grid(config)
    s = v["window_size"]
    windows = -(-h // s) * -(-w // s)
    n_global = len(v["global_blocks"])
    return {"heads": v["num_heads"], "head_dim": v["embed_dim"]
            // v["num_heads"],
            "window": {"blocks": v["depth"] - n_global, "per_image": windows,
                       "grid": [s, s]},
            "global": {"blocks": n_global, "per_image": 1, "grid": [h, w]}}


def attention_flops(shape: dict, heads: int, head_dim: int) -> dict:
    """One attention kind's products per image: `products`, q k^T and the
    weights times v; `relpos`, q R_h and q R_w."""
    kh, kw = shape["grid"]
    n = kh * kw
    per = shape["per_image"] * heads
    return {"products": per * 2 * 2.0 * n * n * head_dim,
            "relpos": per * 2.0 * n * (kh + kw) * head_dim}


def backbone_flops(config: dict) -> float:
    """One image's ViT and simple feature pyramid, forward."""
    v = config["vit"]
    D, p = v["embed_dim"], v["patch_size"]
    M = int(D * v["mlp_ratio"])
    h, w = grid(config)
    shapes = attention_shapes(config)
    f = flops.conv_flops(h, w, p, p, 3, D)  # patch embedding
    for kind in ("window", "global"):
        s = shapes[kind]
        kh, kw = s["grid"]
        tokens = s["per_image"] * kh * kw  # the padded grid of the windows
        a = attention_flops(s, shapes["heads"], shapes["head_dim"])
        block = (flops.dense_flops(tokens, D, 3 * D)
                 + flops.dense_flops(tokens, D, D)
                 + a["products"] + a["relpos"]
                 + flops.dense_flops(h * w, D, M)
                 + flops.dense_flops(h * w, M, D))
        f += s["blocks"] * block
    C = v["out_channels"]
    for scale in v["scale_factors"]:
        lh, lw, c = h, w, D
        if scale == 4.0:
            f += flops.conv_flops(h, w, 2, 2, D, D // 2)
            f += flops.conv_flops(2 * h, 2 * w, 2, 2, D // 2, D // 4)
            lh, lw, c = 4 * h, 4 * w, D // 4
        elif scale == 2.0:
            f += flops.conv_flops(h, w, 2, 2, D, D // 2)
            lh, lw, c = 2 * h, 2 * w, D // 2
        elif scale == 0.5:
            lh, lw = h // 2, w // 2
        f += flops.conv_flops(lh, lw, 1, 1, c, C)
        f += flops.conv_flops(lh, lw, 3, 3, C, C)
    return f


def cycle_flops(config: dict, batch: int) -> dict:
    """One DG cycle (0,1,0,2,0,3,0,4) at `batch`: bench/flops.py's
    cycle_flops for FRCNN with the ResNet-50 FPN's share replaced by the
    ViT's and the pyramid's."""
    canvas = tuple(config["canvas"])
    rois = config["frcnn"]["box_batch_per_image"]
    cyc = flops.cycle_flops("FRCNN", canvas, batch, config["num_domains"],
                            rois, (1, 1, 1, 1))
    fw = cyc["forward"]
    resnet = 8 * fw["frozen"] + 22 * fw["trunk"]
    vit = 22 * backbone_flops(config)
    return dict(cyc, cycle=cyc["cycle"] + (vit - resnet) * batch)


def train_flops_per_image(config: dict, batch: int) -> float:
    cyc = cycle_flops(config, batch)
    return cyc["cycle"] / cyc["images_per_cycle"]


def predict_flops_per_image(config: dict) -> float:
    """One image's forward at predict, the box head over the RPN's
    rpn_post_nms_test RoIs."""
    fw = flops.family_forward_flops("FRCNN", tuple(config["canvas"]),
                                    config["frcnn"]["rpn_post_nms_test"],
                                    (1, 1, 1, 1))
    return backbone_flops(config) + fw["head"]
