#!/usr/bin/env python3
"""Split the time of K2 (RoIAlign backward, csrc/roi_align.cu) on the card.

    python3 scripts/time_roi_align_bwd_parts.py

Builds edited copies of csrc/roi_align.cu under dgod_tpu_torch/_build/parts/
(one nvcc each, all at once) and times each with CUDA events on
chip_smoke.py's K2 inputs (B=8, N=512 adversarial RoIs, C=256, bf16 P2-P5 of
608x1216), in turns, three rounds (scripts/_parts.py):

- base: the source as it is;
- no_accumulate: the gather adds nothing (filter, geometry staging and the
  tile's write remain);
- no_rois: no RoI passes the filter (zeroing, the filter's loads and the
  write remain);
- image_order: the tiles dispatched image by image, finest level first,
  instead of coarsest level first.

Prints the card's name and power limit, each copy's registers, whether it
gives base's bits, and its times in ms. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from _parts import ROOT, build, card, cs, rounds
from dgod_tpu_torch.ops import cuda_roi_align as K

COARSE_FIRST = """  const int B = gridDim.x / L.tile0[LEVELS];
  int lvl = LEVELS - 1, idx = blockIdx.x;
  while (lvl > 0 && idx >= B * (L.tile0[lvl + 1] - L.tile0[lvl])) {
    idx -= B * (L.tile0[lvl + 1] - L.tile0[lvl]);
    --lvl;
  }
  const int b = idx / (L.tile0[lvl + 1] - L.tile0[lvl]);
  const int tile = idx % (L.tile0[lvl + 1] - L.tile0[lvl]);
  const int ty = tile / L.tiles_x[lvl];
  const int tx = tile % L.tiles_x[lvl];"""
IMAGE_ORDER = """  const int b = blockIdx.x / L.tile0[LEVELS];
  const int t0 = blockIdx.x % L.tile0[LEVELS];
  int lvl = 0;
  while (lvl + 1 < LEVELS && t0 >= L.tile0[lvl + 1]) ++lvl;
  const int ty = (t0 - L.tile0[lvl]) / L.tiles_x[lvl];
  const int tx = (t0 - L.tile0[lvl]) % L.tiles_x[lvl];"""
VARIANTS = {"roi_align": {
    "base": [],
    "no_accumulate": [("      if (live) {\n        accumulate(",
                       "      if (false) {\n        accumulate(")],
    "no_rois": [("hit[q] = m.lvl == lvl &&",
                 "hit[q] = false && m.lvl == lvl &&")],
    "image_order": [(COARSE_FIRST, IMAGE_ORDER)],
}}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_roi_align_bwd_parts: no CUDA device", file=sys.stderr)
        return 1
    names = build(VARIANTS)
    card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.randn(cs.B, h, w, cs.C).astype(np.float32))
             .to(dev).to(torch.bfloat16) for h, w in cs.level_shapes()]
    rois = torch.from_numpy(cs.make_rois(rng, cs.N_TRAIN)).to(dev)
    g = torch.from_numpy(rng.randn(cs.B, cs.N_TRAIN, 7, 7, cs.C)
                         .astype(np.float32)).to(dev)
    rounds("roi_align", names["roi_align"], {
        f"N={cs.N_TRAIN}": lambda: K.roi_align_bwd_cuda(feats, rois, g)})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
