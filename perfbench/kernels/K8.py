"""K8, the backward of ViTDet's attention with decomposed relative
positions (dgod_tpu_torch/csrc/relpos_attention.cu: the delta, dK/dV and
dQ kernels of one call): q, k, v, the output, its gradient, the
log-sum-exp and q R_h, q R_w read once; dq, dk, dv and the two bias
gradients written once. What the inputs need is five products of 2 N^2 D
(the logits again, dP, dQ, dK, dV); the kernel's second pass over the
logits and dP (its dQ kernel's) is its own, and not counted.

Sizes and units as in K7.py: a launch is one block's backward, the mean
over the blocks."""

from perfbench.kernels.K7 import attention_work

CATEGORY = "K8 relpos_attention_bwd (port)"
PATTERN = r"relpos_attn_bwd"
RANK = 8
# float32 operations on each logit: the logit again (as K7), p, dS, and
# the two bias-gradient sums
F32_PER_LOGIT = 10
PRODUCTS = 5


def launches() -> int:
    from dgod_tpu_torch.ops import cuda_attention

    return cuda_attention.bwd_launches


def work(sizes: dict, batch: int, max_gt: int) -> tuple:
    # q, k, v, the output and its gradient read, dq, dk, dv written; q R_h
    # and q R_w read, their gradients written
    return attention_work(sizes, batch, PRODUCTS, F32_PER_LOGIT, 8, 2)
