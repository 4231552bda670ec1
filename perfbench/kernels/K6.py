"""K6, the first-k NMS of a predict (dgod_tpu_torch/csrc/nms_topk.cu): the
candidates ranked, the picks written.

Sizes (the builder's, per image): `candidates`, `picks`."""

CATEGORY = "K6 nms_topk (port)"
PATTERN = r"nms_topk_kernel"
RANK = 5


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_nms

    return cuda_nms.launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    return batch * sizes["candidates"] * 5 + batch * sizes["picks"] * 9, 0
