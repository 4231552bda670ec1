#!/usr/bin/env python3
"""Split the time of K1 (RoIAlign forward, csrc/roi_align.cu) and K3 (the
RPN IoU matcher, csrc/iou_match.cu) on the card.

    python3 scripts/time_k1_k3_parts.py

Builds edited copies of the two sources under dgod_tpu_torch/_build/parts/
(one nvcc each, all at once) and times each with CUDA events, in turns,
three rounds (scripts/_parts.py):

K1, on chip_smoke.py's K1 inputs (B=8, N=512 and N=1000 adversarial RoIs,
C=256, bf16 P2-P5 of 608x1216):
- base: the source as it is;
- no_loads: no feature loads (geometry, multiply-adds of zeros and the
  stores remain);
- skip_zero: a corner of weight 0 is not loaded (a predicated load that
  fills zeros);
- no_stores: the bins are pooled but not stored (a store guarded by a test
  no sum passes keeps the work alive);
- cached_stores: write-back stores in place of streaming ones;
- rois_1, rois_4, rois_8: 1, 4 or 8 RoIs per block in place of 2.

K3, on chip_smoke.py's K3 check (319 valid gt over 8 images) and on a
training batch (2-8 gt per image, utils.synthetic.synthetic_batch):
- base;
- pass1_only: the memset and pass 1 (pass 2 not launched);
- pass2_only: pass 2 alone, on the scratch a base call left (the caching
  allocator hands the wrapper the same blocks: its codes equal base's);
- always_divide: pass 1 and 2 divide for pairs that do not intersect;
- no_cull: pass 1 walks every valid gt for every warp (no chunk or warp
  box test);
- no_prune: pass 2 tests the rescue against every valid gt of positive
  best (no bound by the block's largest max, no box test);
- per_lane_1, per_lane_2: pass 1 with 1 or 2 anchors per lane in place of
  4 (blocks of 256 or 512 anchors);
- per_thread_1, per_thread_2: pass 2 with 1 or 2 anchors per thread in
  place of 4 (blocks of 256 or 512 anchors);
- layout_1: one anchor per lane and per thread in both passes;
- fine_first: both passes dispatch the anchors in index order, the finest
  level first, in place of the coarsest first.

A copy that skips a store may show base's output where the caching
allocator hands it the memory of base's last result.

Prints the card's name and power limit, each copy's registers, whether it
gives base's bits, and its times in ms. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from _parts import ROOT, build, card, cs, rounds
from dgod_tpu_torch.ops import cuda_matchers, cuda_roi_align
from dgod_tpu_torch.utils.synthetic import synthetic_batch

LOAD = "raw[k] = __ldg("
STORE = "__stcs(reinterpret_cast<float4*>(dst + v * VEC + c),"
VARIANTS = {
    "roi_align": {
        "base": [],
        "no_loads": [(LOAD, "raw[k] = make_uint4(0u, 0u, 0u, 0u); (")],
        "skip_zero": [(LOAD, "raw[k] = w[k] == 0.0f ? make_uint4(0u, 0u, 0u,"
                             " 0u) : __ldg(")],
        "no_stores": [(STORE, "if (acc[c] + acc[c + 1] + acc[c + 2] + "
                              "acc[c + 3] == 1.2345e-30f) " + STORE)],
        "cached_stores": [(STORE, STORE.replace("__stcs", "__stwb"))],
        "rois_1": [("FWD_ROIS = 2;", "FWD_ROIS = 1;")],
        "rois_4": [("FWD_ROIS = 2;", "FWD_ROIS = 4;")],
        "rois_8": [("FWD_ROIS = 2;", "FWD_ROIS = 8;")],
    },
    "iou_match": {
        "base": [],
        "pass1_only": [("  match_kernel<<<", "  if (false) match_kernel<<<")],
        "pass2_only": [("  if (G > 0) {", "  if (false) {"),
                       ("  best_kernel<<<", "  if (false) best_kernel<<<")],
        "always_divide": [
            ("  if (!(iw > 0.0f && ih > 0.0f)) return 0.0f;\n", ""),
            ("const float inter = __fmul_rn(iw, ih);",
             "const float inter = iw > 0.0f && ih > 0.0f ? "
             "__fmul_rn(iw, ih) : 0.0f;")],
        "no_cull": [("slot.valid && meets(slot.box, chunk_box)", "slot.valid"),
                    ("if (!meets(g, box)) continue;", "")],
        "no_prune": [("slot.best <= block_max &&", ""),
                     ("meets(slot.box, block_box)", "true")],
        "per_lane_1": [("PER_LANE = 4;", "PER_LANE = 1;")],
        "per_lane_2": [("PER_LANE = 4;", "PER_LANE = 2;")],
        "per_thread_1": [("PER_THREAD = 4;", "PER_THREAD = 1;")],
        "per_thread_2": [("PER_THREAD = 4;", "PER_THREAD = 2;")],
        "layout_1": [("PER_LANE = 4;", "PER_LANE = 1;"),
                     ("PER_THREAD = 4;", "PER_THREAD = 1;")],
        "fine_first": [("chunk = chunks - 1 - blockIdx.x / B", "chunk = "
                        "blockIdx.x / B"),
                       ("(gridDim.x - 1 - blockIdx.x) * BLOCK2", "blockIdx.x"
                        " * BLOCK2")],
    },
}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_k1_k3_parts: no CUDA device", file=sys.stderr)
        return 1
    names = build(VARIANTS)
    card()
    dev = torch.device("cuda")

    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.randn(cs.B, h, w, cs.C).astype(np.float32))
             .to(dev).to(torch.bfloat16) for h, w in cs.level_shapes()]
    rois = {n: torch.from_numpy(cs.make_rois(rng, n)).to(dev)
            for n in (cs.N_TRAIN, cs.N_TEST)}
    rounds("roi_align", names["roi_align"], {
        f"N={n}": (lambda r=r: cuda_roi_align.roi_align_fwd_cuda(feats, r))
        for n, r in rois.items()})
    del feats, rois

    from dgod_tpu_torch.models.faster_rcnn import FRCNNDetector

    anchors = FRCNNDetector(canvas=cs.CANVAS,
                            backbone_block_counts=(1, 1, 1, 1)
                            ).anchors.to(dev).contiguous()
    check = cs.k3_check_inputs(anchors)
    batch = synthetic_batch(np.random.RandomState(5), cs.B, cs.CANVAS, 3)
    train = (torch.from_numpy(batch["boxes"]).to(dev),
             torch.from_numpy(batch["gt_valid"]).to(dev))
    print(f"K3 inputs: valid gt per image, check "
          f"{check[1].sum(1).tolist()}, training {train[1].sum(1).tolist()}")
    rounds("iou_match", names["iou_match"], {
        label: (lambda gt=gt, v=v: cuda_matchers.iou_match_cuda(
            gt, v, anchors, 0.7, 0.3, True))
        for label, (gt, v) in (("check", check), ("training", train))},
        after_base=("pass2_only",))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
