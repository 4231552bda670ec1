"""K4, the FCOS matcher (dgod_tpu_torch/csrc/fcos_match.cu): every location
against the padded ground truth, its match written.

Sizes (the builder's, per image): `locations`."""

CATEGORY = "K4 fcos_match (port)"
PATTERN = r"fcos_match_kernel"
RANK = 3


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_matchers

    return cuda_matchers.fcos_launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    R = sizes["locations"]
    return batch * max_gt * 17 + R * 16 + batch * R * 4, 0
