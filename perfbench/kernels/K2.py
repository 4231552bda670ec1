"""K2, RoIAlign's backward (dgod_tpu_torch/csrc/roi_align.cu::
bwd_geometry_kernel + bwd_gather_kernel): the pooled gradient read, the
gradients of the FPN levels written.

Sizes (the builder's, per image): `rois`, `channels`, `levels` ([h, w] of
each pooled level)."""

CATEGORY = "K2 roi_align_bwd (port)"
PATTERN = r"bwd_(geometry|gather)_kernel|\bbwd_kernel|cast_bf16_kernel"
RANK = 2


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_roi_align

    return cuda_roi_align.bwd_launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    n_roi = batch * sizes["rois"]
    C = sizes["channels"]
    pooled = n_roi * 49 * C * 4
    ops = n_roi * 49 * 4 * 8 * C  # 4 samples x 4 corners x (mul + add)
    grads = sum(batch * h * w * C * 2 for h, w in sizes["levels"])
    return pooled + n_roi * 16 + grads, ops
