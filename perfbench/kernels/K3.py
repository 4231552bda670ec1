"""K3, the IoU matcher (dgod_tpu_torch/csrc/iou_match.cu): every anchor
against the padded ground truth, its match written.

Sizes (the builder's, per image): `locations`, the anchors matched."""

CATEGORY = "K3 iou_match (port)"
PATTERN = r"best_kernel|match_kernel|init_best"
RANK = 4  # after K4, whose fcos_match_kernel this pattern also matches


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_matchers

    return cuda_matchers.launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    R = sizes["locations"]
    return batch * max_gt * 17 + R * 16 + batch * R * 4, 0
