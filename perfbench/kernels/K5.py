"""K5, the RPN's decode and NMS (dgod_tpu_torch/csrc/proposals.cu): each
level's top-k decoded, masked and scanned.

Sizes (the builder's, per image): `entries`, the top-k entries of all
levels."""

CATEGORY = "K5 decode_nms (port)"
PATTERN = r"\b(decode|mask|scan)_kernel\b"
RANK = 6


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_proposals

    return cuda_proposals.launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    entries = batch * sizes["entries"]
    return entries * (16 + 16 + 16 + 1) + batch * 8, 30 * entries
