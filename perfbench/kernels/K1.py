"""K1, RoIAlign's forward (dgod_tpu_torch/csrc/roi_align.cu::fwd_kernel):
each RoI's 7x7 bins at 2x2 samples of 4 corners each, from its FPN level.

Sizes (the builder's, per image): `rois`, `channels`."""

CATEGORY = "K1 roi_align_fwd (port)"
PATTERN = r"\bfwd_kernel"
RANK = 1


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_roi_align

    return cuda_roi_align.fwd_launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    """(bytes, float32 operations) of one launch: the pooled output written
    and each RoI's box read."""
    n_roi = batch * sizes["rois"]
    C = sizes["channels"]
    pooled = n_roi * 49 * C * 4
    ops = n_roi * 49 * 4 * 8 * C  # 4 samples x 4 corners x (mul + add)
    return pooled + n_roi * 16, ops
