#!/usr/bin/env python3
"""Split the time of K2 (RoIAlign backward, csrc/roi_align.cu) on the card.

    python3 scripts/time_roi_align_bwd_parts.py

Builds edited copies of csrc/roi_align.cu under dgod_tpu_torch/_build/parts/
(one nvcc each, all at once) and times each with CUDA events on
chip_smoke.py's K2 inputs (B=8, N=512 adversarial RoIs, C=256, bf16 P2-P5 of
608x1216), in turns, three rounds:

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

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dgod_tpu_torch.ops import _build  # noqa: E402
from dgod_tpu_torch.ops import cuda_roi_align as K  # noqa: E402

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
VARIANTS = {
    "base": [],
    "no_accumulate": [("      if (live) {\n        accumulate(",
                       "      if (false) {\n        accumulate(")],
    "no_rois": [("hit[q] = m.lvl == lvl &&",
                 "hit[q] = false && m.lvl == lvl &&")],
    "image_order": [(COARSE_FIRST, IMAGE_ORDER)],
}


def build(out_dir: Path):
    src = (_build.CSRC / "roi_align.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has the text "
                                 f"this variant edits")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [line.split("info    :")[-1].strip() for line in
                log.splitlines() if "registers" in line]
        print(f"{name}: {regs[0] if regs else ''}")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_roi_align_bwd_parts: no CUDA device", file=sys.stderr)
        return 1
    out_dir = _build.BUILD_DIR / "parts"
    build(out_dir)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.randn(cs.B, h, w, cs.C).astype(np.float32))
             .to(dev).to(torch.bfloat16) for h, w in cs.level_shapes()]
    rois = torch.from_numpy(cs.make_rois(rng, cs.N_TRAIN)).to(dev)
    g = torch.from_numpy(rng.randn(cs.B, cs.N_TRAIN, 7, 7, cs.C)
                         .astype(np.float32)).to(dev)

    def use(name):  # the wrapper loads the copy's library from now on
        _build._loaded["roi_align"] = ctypes.CDLL(str(out_dir / f"{name}.so"))
        K._fns.clear()

    use("base")
    ref = K.roi_align_bwd_cuda(feats, rois, g)
    times = {name: [] for name in VARIANTS}
    for rnd in range(3):
        for name in VARIANTS:
            use(name)
            if rnd == 0:
                out = K.roi_align_bwd_cuda(feats, rois, g)
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"{name}: the same bits as base: {same}")
            times[name].append(cs.cuda_time_ms(
                lambda: K.roi_align_bwd_cuda(feats, rois, g), iters=20))
    _build._loaded.pop("roi_align")
    K._fns.clear()
    for name, t in times.items():
        print(f"{name:14s} ms: " + " ".join(f"{x:.3f}" for x in t))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
