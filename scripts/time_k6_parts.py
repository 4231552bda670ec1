#!/usr/bin/env python3
"""Split the time of K6 (first-k greedy NMS, csrc/nms_topk.cu) on the card,
and time K4's layouts (the FCOS matcher, csrc/fcos_match.cu).

    python3 scripts/time_k6_parts.py [--parent DIR]

Builds edited copies of the two sources under dgod_tpu_torch/_build/parts/
(one nvcc each, all at once) and times each with CUDA events, queued
behind a device sleep (utils.timing.device_time_ms), in turns, three rounds
(scripts/_parts.py).
With --parent, DIR is another checkout of the repository (a `git archive`
of an earlier commit): its sources, as they are (K6's given the entry
point that reports its capacity, where it has none), are timed in the
same turns as "parent".

K6, on chip_smoke.py's NMS rows (B=8, k=100: the FRCNN predict's K=9000
at IoU 0.5, the FCOS predict's K=4450 at IoU 0.6, and the adversarial
rows three, disjoint, zeros and empty at K=9000, `chip_smoke.NMS_ROWS`):
- base: the source as it is;
- compact_only: the compaction alone (nothing kept);
- select_only, gather_only, order_only: compaction and the first tile's
  selection; and its gather; and its sort; then stop (nothing kept);
- one_step: the first tile's first scan step, then stop (its picks kept,
  nothing filtered);
- no_filter_pass: the pool filter drops nothing and ends the row (picks
  differ where a second tile is needed);
- no_kept_test: no candidate and no pool entry is tested against kept
  boxes (the tiles' bitmask scans alone decide; picks differ);
- no_mask: the scan steps' 64x64 IoU bitmasks are not computed (every
  row kept; picks differ);
- divide: the IoU threshold test divides (__fdiv_rn) in place of the
  exact comparison in double (the same picks);
- tile_min_64, tile_min_512: a selection stops once it has 64 or 512
  keys, not 128;
- top_digit: the first select pass counts the keys' top 13 bits anew
  (the compaction's counts below the top 4 bits unused);
- filter_0, filter_64: the pool filter after a tile that kept at most 0
  (never) or 64 boxes, in place of 16.

K4, on chip_smoke.py's check and on a training batch (2-8 gt per image,
utils.synthetic.synthetic_batch):
- base (blocks of 256 threads, one anchor each);
- threads_128, threads_512: blocks of 128 or 512 threads.

Prints the card's name and power limit, each copy's registers, whether it
gives base's bits, and its times in ms. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch

from _parts import ROOT, build, card, cs, rounds
from dgod_tpu_torch.ops import cuda_matchers, cuda_nms
from dgod_tpu_torch.utils.synthetic import synthetic_batch

GATHER = ("    for (int i0 = 0; i0 < n; i0 += THREADS) {\n"
          "      const int i = i0 + tid;\n"
          "      const u64 key = i < n ? pool[i] : NONE;\n"
          "      const bool in = key >= floor && key < bound;\n")
GATHERED = "    floor = bound;\n"
DECIDE = ("    nk = decide_tile(t, nk, filt, k, kbox, karea, kidx, thr, s, "
          "parity);\n")
STEP = "    nk += s.misc;\n"
KEPT_TEST = ("  for (int j = lo; j < hi; ++j)\n"
             "    if (over(kbox[j], karea[j], q, qa, thr)) return true;\n")
MASK = "bit = over(p4, area(p4), c4, area(c4), thr);"
EXACT = ("  const double lhs = static_cast<double>(inter);\n"
         "  const double rhs = __dmul_rn(t.mid, static_cast<double>(uni));\n"
         "  return lhs > rhs || (lhs == rhs && t.up_even);\n")
VARIANTS = {
    "nms_topk": {
        "base": [],
        "compact_only": [("  while (nk < k && left > 0) {",
                          "  while (nk < k && left < 0) {")],
        "select_only": [(GATHER, "    if (bound == 1ull) left = 1;\n"
                                 "    break;\n" + GATHER)],
        "gather_only": [(GATHERED, GATHERED + "    break;\n")],
        "order_only": [(DECIDE, "    break;\n")],
        "one_step": [(STEP, STEP + "    break;\n"),
                     (DECIDE, DECIDE + "    break;\n")],
        "no_filter_pass": [("      int drops = 0;\n",
                            "      left = 0;\n      continue;\n"
                            "      int drops = 0;\n")],
        "no_kept_test": [(KEPT_TEST, "")],
        "no_mask": [(MASK, "bit = p4.x == 1.2345e-30f && c4.x == p4.x;")],
        "divide": [(EXACT, "  return __fdiv_rn(inter, uni) > t.thr;\n")],
        "tile_min_64": [("TILE_MIN = 128;", "TILE_MIN = 64;")],
        "tile_min_512": [("TILE_MIN = 128;", "TILE_MIN = 512;")],
        "top_digit": [("        if (s.sh.top_lt == 0 && "
                       "s.sh.top_eq > TILE) {", "        if (false) {")],
        "filter_0": [("FILTER_MAX = 16;", "FILTER_MAX = 0;")],
        "filter_64": [("FILTER_MAX = 16;", "FILTER_MAX = 64;")],
    },
    "fcos_match": {
        "base": [],
        "threads_128": [("THREADS = 256;", "THREADS = 128;")],
        "threads_512": [("THREADS = 256;", "THREADS = 512;")],
    },
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K6 and K4 sources are "
                         "timed beside these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k6_parts: no CUDA device", file=sys.stderr)
        return 1
    extra = {}
    if args.parent is not None:  # the other checkout's sources, as they are
        extra = {source: {"parent": (args.parent / "dgod_tpu_torch" / "csrc"
                                     / f"{source}.cu").read_text()}
                 for source in VARIANTS}
        if "nms_topk_max_entries" not in extra["nms_topk"]["parent"]:
            # the wrapper asks for the limit; an older kernel reports none
            # (its own launch refuses what it cannot hold)
            extra["nms_topk"]["parent"] += (
                '\nextern "C" int nms_topk_max_entries(int) '
                '{ return 0x7fffffff; }\n')
    names = build(VARIANTS, extra)
    card()
    dev = torch.device("cuda")
    from dgod_tpu_torch.ops.nms import _class_offsets

    rng = np.random.RandomState(12)  # chip_smoke.check_nms_topk's rows
    rows = [(f"K={K}", thr, cs.nms_candidates(rng, K))
            for K, thr in ((9000, 0.5), (4450, 0.6))]
    rows += [(kind, 0.5, cs.nms_adversarial(rng, kind))
             for kind in cs.NMS_ROWS]
    calls = {}
    for label, thr, arrays in rows:
        boxes, scores, labels, valid = (torch.from_numpy(a).to(dev)
                                        for a in arrays)
        off = _class_offsets(boxes, labels).contiguous()
        calls[label] = (lambda off=off, s=scores, v=valid, thr=thr:
                        cuda_nms.nms_topk_cuda(off, s, v, thr, 100))
    rounds("nms_topk", names["nms_topk"], calls)

    from dgod_tpu_torch.models.fcos import fcos_anchors_for

    anchors_np, counts = fcos_anchors_for(cs.CANVAS)
    anchors = torch.from_numpy(anchors_np).to(dev)
    gt, valid = cs.fcos_match_gt(np.random.RandomState(11), anchors_np,
                                 counts)
    batch = synthetic_batch(np.random.RandomState(5), cs.B, cs.CANVAS, 3)
    inputs = {"check": (gt, valid),
              "training": (batch["boxes"], batch["gt_valid"])}
    print(f"K4 inputs: valid gt per image, check {valid.sum(1).tolist()}, "
          f"training {batch['gt_valid'].sum(1).tolist()}")
    rounds("fcos_match", names["fcos_match"], {
        label: (lambda g=torch.from_numpy(g).to(dev),
                v=torch.from_numpy(v).to(dev):
                cuda_matchers.fcos_match_cuda(anchors, g, v, counts))
        for label, (g, v) in inputs.items()})
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
