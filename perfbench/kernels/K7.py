"""K7, the forward of ViTDet's attention with decomposed relative positions
(dgod_tpu_torch/csrc/relpos_attention.cu::relpos_attn_fwd_kernel): q, k, v
and the float32 q R_h, q R_w read once, the output and each row's
log-sum-exp written once; the products q k^T and p v on the tensor cores.

Sizes (the builder's, per image): `heads`, `head_dim`, and for `window`
and `global` the blocks of that kind, the attentions per image and their
token grid. A launch is one block's: its work is the mean over the
forward's blocks, which launch in that ratio.

Operations are counted in the units bench/kernels.py::bound_s divides by,
the float32 rate: the bf16 tensor-core products scaled by F32_FLOPS /
BF16_PEAK_FLOPS, or the float32 work on the logits where that is larger
(not the sum), so that the share reads against the bf16 peak."""

from perfbench.bench.kernels import BF16_PEAK_FLOPS, F32_FLOPS

CATEGORY = "K7 relpos_attention_fwd (port)"
PATTERN = r"relpos_attn_fwd"
RANK = 7
# float32 operations on each logit: scale, the two bias terms, max, exp2,
# sum
F32_PER_LOGIT = 6
PRODUCTS = 2  # q k^T, p v


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_attention

    return cuda_attention.fwd_launches


def attention_work(sizes: dict, batch: int, products: int,
                   f32_per_logit: int, tensors: int, rel_passes: int) -> tuple:
    """(bytes, operations in float32 units) of one launch, the mean over
    the blocks: `products` products of 2 N^2 D each; `tensors` [N, D] bf16
    tensors an attention moved (read or written), `rel_passes` times the
    float32 q R_h and q R_w, and the log-sum-exp once."""
    heads, D = sizes["heads"], sizes["head_dim"]
    total_bytes = total_ops = blocks = 0
    for kind in ("window", "global"):
        s = sizes[kind]
        kh, kw = s["grid"]
        n = kh * kw
        att = batch * s["per_image"] * heads
        mma = att * products * 2.0 * n * n * D
        f32 = att * f32_per_logit * float(n * n)
        nbytes = att * n * (tensors * D * 2 + rel_passes * (kh + kw) * 4 + 4)
        total_bytes += s["blocks"] * nbytes
        total_ops += s["blocks"] * max(mma * F32_FLOPS / BF16_PEAK_FLOPS,
                                       f32)
        blocks += s["blocks"]
    return total_bytes / blocks, total_ops / blocks


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    # q, k, v read and the output written; q R_h, q R_w read
    return attention_work(sizes, batch, PRODUCTS, F32_PER_LOGIT, 4, 1)
