"""Model FLOPs of the TINYVIT stand-in as bench/flops.py counts a model's
(2*M*N*K per convolution and dense layer; attention's two products as
well): DG Faster R-CNN's with the ResNet-50 FPN's share replaced by the
backbone's, which trains in every half of the DG cycle but mode 2's."""

from perfbench.bench import flops


def tokens(config: dict) -> tuple:
    p = config["vit"]["patch"]
    H, W = config["canvas"]
    return -(-H // p), -(-W // p)


def backbone_flops(config: dict, out_channels: int = 256) -> float:
    """One image's backbone forward."""
    vit = config["vit"]
    p, D, M = vit["patch"], vit["dim"], vit["mlp"]
    h, w = tokens(config)
    n = h * w
    f = flops.conv_flops(h, w, p, p, 3, D)
    f += flops.dense_flops(n, D, 3 * D) + flops.dense_flops(n, D, D)
    f += 2 * 2.0 * n * n * D  # q k^T and the weights times v
    f += flops.dense_flops(n, D, M) + flops.dense_flops(n, M, D)
    return f + flops.conv_flops(h, w, 1, 1, D, out_channels)


def train_flops_per_image(config: dict, batch: int) -> float:
    canvas = tuple(config["canvas"])
    cyc = flops.cycle_flops("FRCNN", canvas, batch, config["num_domains"],
                            config["frcnn"]["box_batch_per_image"],
                            (1, 1, 1, 1))
    fw = cyc["forward"]
    # the 8 halves: 7 forward and backward (3x), mode 2 forward only
    resnet = 8 * fw["frozen"] + 22 * fw["trunk"]
    vit = 22 * backbone_flops(config)
    return cyc["cycle"] / cyc["images_per_cycle"] + (vit - resnet) / 8


def predict_flops_per_image(config: dict) -> float:
    fw = flops.family_forward_flops("FRCNN", tuple(config["canvas"]),
                                    config["frcnn"]["rpn_post_nms_test"],
                                    (1, 1, 1, 1))
    return backbone_flops(config) + fw["head"]
