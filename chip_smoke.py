#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dgod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any fault:

1. identify the card (nvidia-smi name and power limit) and set TF32 off for
   float32 convolutions and matmuls;
2. build every CUDA kernel from dgod_tpu_torch/csrc (one nvcc per source,
   all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (K1 RoIAlign forward, K2 its backward, K3 the RPN IoU
   matcher with and without low-quality matches, on images with and
   without a gt that meets no anchor, K4 the FCOS centre-sampling matcher,
   K5 the RPN proposal decode + NMS at the training and predict shapes, K6
   first-k greedy NMS at both predicts' shapes and on adversarial rows:
   copies of 3 boxes (every rank passed for 3 picks), disjoint boxes (the
   first 100 ranks picked), +0.0/-0.0 ties and nothing valid, and at the
   most entries its shared memory holds), timing both with CUDA events
   (K1, K3 and K4 also as issued, without the device sleep), and require
   K1 and K3 to refuse inputs that are not 16-byte aligned, and K6 one
   entry more than it holds, before any launch; then
   run a small float32 model of each family on the card and
   on the CPU with the same weights, batch and random draws and require
   the same losses; K7 and K8, ViTDet's fused attention with decomposed
   relative positions (CUDA C++ on wgmma), forward and backward against
   the plain version at the ViTDet-B cell's window and global shapes and
   at two grids whose edges its 64-row tiles meet (5 x 19; 38 x 76 at
   batch 1) in bf16, each no further from float32 than the plain version
   computed in bf16 and through autograd the direct calls' bit for bit,
   timed (K8's delta, dK/dV and dQ kernels apart, from torch.profiler)
   beside its bound and at the cell's shapes beside the plain version and
   PyTorch's scaled_dot_product_attention with the bias materialised
   (`library_ms`, the yardstick; the port never calls it); K9, the
   optimizer's one-pass update, bit-identical to its plain
   loop over three updates on ViTDet-B's and FCOS's leaves (Adam) and
   FRCNN's (SGD), with mixed step counts, None, channels_last and
   misaligned gradients and inactive leaves, timed on each mode-0 set
   beside its bound, the plain loop and torch.optim.Adam(fused=True);
4. train: the full-width DG Faster R-CNN (ResNet-50 (3,4,6,3), 608x1216,
   default FRCNNConfig, 3 domains, bf16, batch 8, random weights from a
   seed) runs two DG cycles of fused pairs (0,1), (0,2), (0,3), (0,4) under
   SGD(2e-3, wd 5e-4): every loss finite, each pair moves only the
   parameter groups its modes activate;
5. predict: the eval step on one batch, shapes and finiteness checked;
6. the same two phases for the full-width DG FCOS (P3..P7, 9 classes,
   3 domains, bf16, batch 8) under Adam(1e-4, wd 1e-4);
7. the kernels' launch counts: each family's path is driven with every
   count set to 0 just before it and read just after. Every pair and every
   predict must launch exactly the kernels its family runs (K2 not in mode
   2's frozen half, K4 once in each FCOS pair, shared by its halves, K5 in
   each FRCNN half and predict, K6 once per predict), and every kernel must
   have run on some path; K1-K6 are held against their plain versions once
   more on the last inputs the path gave them (K2 also against itself: two
   calls, the same bits), and K3, K4 and K6 are timed on them (the
   training path's 2-8 gt per image; the predict's candidates);
8. the CLI, the product's entry point, at full width for each family: a
   synthetic dataset in the real datasets' formats (source domains a, b,
   c with 16 train and 8 val images each, target i with 8 val images; a,
   c, i as 600x1200 PNGs whose rows cycle through the five PNG filters, b
   as the 720x1280 fixture JPEGs) in a temporary --data_root; the
   calibrated random init saved as the warm start .ckpt;
   `dgod_tpu_torch.cli.main` for `--exp dg --max_epochs 1
   --batch_size 8 --eval_batch_size 8` (6 fused pairs, a validation and a
   test sweep), counts from 0 around it; then the test mAP finite in
   [0, 1], the best checkpoint finite and moved from the init, the launches
   those of 6 pairs and 4 predicts, and a `--max_epochs 0` rerun giving
   the same test mAP;
9. the torchvision warm start of each family: a calibrated full-width
   init written as a torchvision checkpoint (COCO's 91-class predictor or
   cls_logits; for FCOS also a plain ImageNet resnet50), loaded by the CLI
   (`--torch_weights X.pth --max_epochs 0`) into its own model: every
   ported tensor equal to the written one bit for bit, the class-dependent
   layers (and, from the resnet50, all but the body) the model's init, the
   test mAP in [0, 1]; then one finite pair step (0,1), counts from 0
   around them;
10. each family learns on the card, non_dg, through the kernels, with the
   JAX convergence script's recipe (random weights from model seed 0,
   FrozenBatchNorm at identity), to train mAP@0.5 >= 0.6: FCOS at the CPU
   learning test's size within 60 epochs, FRCNN (600-step LR warm-up) at
   300x600 within 100 epochs (`learn_size` says why); counts from 0
   around each;
11. multi-GPU training (`--mesh`), run before phase 8: a one-rank NCCL
   group (a file store in a temporary directory) and, per family, the
   full-width model (calibrated init of seed 0, 4 batches of 8) through
   `Trainer` twice without a mesh and once with `mesh=auto`, under
   deterministic cuDNN and deterministic algorithms: one DG cycle of the
   four fused pairs, then a validation over 2 batches, counts from 0
   around each. Two plain cycles must be bit-identical, and so must the
   mesh cycle (parameters and optimizer state), with the same val mAP;
   the mesh cycle must launch the kernels of 4 pairs and 2 predicts. With
   more than one card, scripts/check_multigpu_torch.py then runs over them
   (DP and TP against one-card cycles of the same arithmetic, images/s per
   rank count); with one, that part is reported as not run;
12. the data path without cv2, run after phase 9: build the C++ decode
   (csrc/host/image_decode.cpp) and require every fixture JPEG
   (tests/fixtures/jpeg, written by cv2) to decode to the sha256 of
   cv2.imread's RGB recorded beside it, and 32 1024x2048 PNGs whose rows
   cycle through the five filters (`png_filtered`) to decode to their
   source arrays; print the decode ms per image (C++ PNG, C++ JPEG, the
   Python unfilter on one image); run TrainLoader and ProcessTrainLoader
   over two DG epochs of a mixed dataset (a, c: those PNGs; b: the
   720x1280 JPEGs), whose batches must be bit-identical, the process
   loader's in pinned memory, printing each one's images/s per epoch, its
   first batch's latency and the host's cores; run
   phase 8 for FRCNN with --process_loader (its launches checked the
   same way, counts from 0 around it) beside the thread loader's images/s;
   fit FRCNN for one epoch through `Trainer` into a .ckpt and into a
   directory store under deterministic algorithms (the same checkpoint
   bits and test mAP), and save into the directory store just before an
   in-place change of every tensor (the step written holds the values
   before it, and no older step is left); and load the calibrated
   full-width FRCNN written in the JAX package's .ckpt layout
   (`jax_ckpt_bytes`) through the CLI's warm start, every tensor and one
   predict equal to the in-memory model's bit for bit;
13. the measurement entry points, run after phase 12 in short settings,
   each with the kernels' counts from 0 around it and its launches those
   of the pairs, mode steps, predicts and stage prefixes it reports, every
   number it prints finite and positive (a stage's difference of two times
   finite): scripts/bench_e2e_torch.py for FRCNN over phase 12's 1024x2048
   PNGs (12 pairs, with threads and with --process_loader; occupancy at
   most 1.05), scripts/bench_eval_torch.py for both families (batch 1 and
   8, a 4-batch sweep whose mAP must equal a direct `Trainer.validate` on
   the same batches, both under deterministic algorithms, and the stage
   profile), scripts/bench_detail_torch.py for both (2 timed calls per
   mode), scripts/roofline_backbone_torch.py (3 timed calls per stage;
   every share and MFU at most 1.05, else a count is wrong), and one FRCNN
   pair inside `utils/logging.profile_steps`, whose trace must name the
   CUDA kernels of K1, K2, K3 and K5 (their symbols in csrc/roi_align.cu,
   iou_match.cu and proposals.cu).

Each family's main path also reports its second DG cycle's images/s and
MFU (`utils.flops.train_mfu`, against the H100 SXM's dense bf16 peak).

14. ViTDet-B under DG Faster R-CNN (`--backbone vitdet_b`), run after the
   main paths: the full-width model (bf16, batch 8, Adam) runs two DG
   cycles with every loss finite, 12 K7 launches in each half and 12 K8
   in each half that trains the backbone (all but mode 2's); then the eval
   step at batch 1 serves a CUDA graph's replay whose detections are the
   eager call's, bit for bit. Every update of phases 4-7 and 14 goes
   through K9 (no leaf through the plain loop).

Output: one line per phase, then the card's name and power limit, then one
JSON line {"kernels": [...]} (times, errors, bounds, and the launches of
the two main paths, phases 4-7; phases 8-13 print theirs on lines of
their own), and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import struct
import sys
import tempfile
import time

import numpy as np

if __name__ != "__mp_main__":
    # a spawned child (ProcessTrainLoader's) re-runs this file's top level
    # as __mp_main__: it needs none of torch, whose import costs seconds
    import torch

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989.4e12  # dense bf16 on the tensor cores

# The previous designs' times on an NVIDIA H100 80GB HBM3 at 700 W, at the
# same shapes: K1 as one block per RoI with a thread per channel, K2 as an
# f32 atomic scatter with a zero and a cast pass, K3 with gt on the thread
# axis of its first pass, K5 with a scan that decided one row per step, K6
# at K=9000 and 4450 as k block-wide argmax-and-suppress rounds (all from
# this script); K4 walking every gt of its image for each anchor, and K6's
# adversarial rows, from scripts/time_k6_parts.py --parent on the same
# inputs
PREVIOUS_MS = {"K1 train": 0.566, "K1 predict": 0.982, "K2": 1.853,
               "K3": 0.707, "K4": 0.0241, "K5 train": 1.047,
               "K5 predict": 0.458, "K6 K=9000": 0.486, "K6 K=4450": 0.296,
               "K6 three": 0.0201, "K6 disjoint": 0.4768, "K6 zeros": 0.4861,
               "K6 empty": 0.0064}

CANVAS = (608, 1216)
B = 8
N_TRAIN, N_TEST = 512, 1000
C = 256
G = 128
REG_WEIGHTS = (0.5, 0.5, 0.5, 0.05, 1e-4)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def expect_refused(label: str, fn, launches) -> None:
    """`fn()` must raise ValueError before the count `launches()` moves."""
    before = launches()
    try:
        fn()
    except ValueError as e:
        print(f"{label}: refused ({e})")
    else:
        fail(f"{label}: the wrapper took it")
    if launches() != before:
        fail(f"{label}: launched before refusing")


def level_shapes():
    return [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in (4, 8, 16, 32)]


def make_rois(rng: np.random.RandomState, n: int) -> np.ndarray:
    """RoIs over the canvas: mostly ordinary boxes at every level, plus
    slivers, boxes partly or wholly outside the image, boxes larger than the
    canvas and degenerate ones."""
    H, W = CANVAS
    rois = np.zeros((B, n, 4), np.float32)
    for b in range(B):
        x1 = rng.uniform(-50, W, n)
        y1 = rng.uniform(-50, H, n)
        side = np.exp(rng.uniform(np.log(4), np.log(900), n))
        aspect = np.exp(rng.uniform(-1.5, 1.5, n))
        r = np.stack([x1, y1, x1 + side * aspect, y1 + side / aspect], 1)
        specials = [
            [0, 0, 0, 0],                    # degenerate
            [10, 100, W - 10, 102],          # wide sliver
            [500, 0, 501.5, H],              # tall sliver
            [-300, -200, W + 300, H + 200],  # exceeds the canvas
            [W + 20, H + 20, W + 80, H + 90],  # wholly outside
            [-90, -60, -10, -5],             # wholly outside, negative
            [W - 8, H - 8, W + 8, H + 8],    # straddles the corner
            [0.5, 0.5, 1.0, 1.0],            # sub-pixel
        ]
        r[:len(specials)] = specials
        rois[b] = r
    return rois


def hold_k2(label, feats, rois, g):
    """K2 against autograd of the plain version on `feats`' shapes: the VJP
    does not depend on the feature values, so float32 copies give the
    exact reference grads. On f32 features K2 returns its f32 sums, taken
    in another order than autograd's (2e-5 of the level's largest grad);
    on bf16 features it returns them rounded once to bf16, held against
    the reference rounded to bf16 (one bf16 step where the order moves a
    sum across a rounding boundary). Grads under 1 (the main path's) are
    held relative to their own largest value. A second bf16 call must give
    the same bits: K2 sums each cell in a fixed order. -> (max error,
    touched cells)."""
    from dgod_tpu_torch.ops import cuda_roi_align as K
    from dgod_tpu_torch.ops.roi_align import roi_align_plain

    feats32 = [f.detach().float() for f in feats]
    feats16 = [f.detach().to(torch.bfloat16) for f in feats]
    leaves = [f.clone().requires_grad_(True) for f in feats32]
    ref_grads = torch.autograd.grad(roi_align_plain(leaves, rois), leaves, g)
    del leaves
    got32 = K.roi_align_bwd_cuda(feats32, rois, g)
    got16 = K.roi_align_bwd_cuda(feats16, rois, g)
    again16 = K.roi_align_bwd_cuda(feats16, rois, g)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got16, again16))
    print(f"K2 {label}: two bf16 calls give bit-identical grads: {same}")
    if not same:
        fail(f"K2 is not deterministic ({label})")
    err_bwd = 0.0
    touched_cells = 0
    for lvl, (ref, a32, a16) in enumerate(zip(ref_grads, got32, got16)):
        ref_max = float(ref.abs().max())
        scale = ref_max if 0.0 < ref_max < 1.0 else max(1.0, ref_max)
        err32 = float((ref - a32).abs().max())
        ref16 = ref.to(torch.bfloat16).float()
        d16 = (ref16 - a16.float()).abs()
        err16 = float(d16.max())
        print(f"K2 {label} level {lvl}: max_abs_err f32 {err32:.3e}, "
              f"bf16 {err16:.3e} (ref max {ref_max:.3e})")
        if a32.dtype != torch.float32 or a16.dtype != torch.bfloat16:
            fail("K2 must return grads in the feature dtype")
        if not torch.isfinite(a32).all() or err32 > 2e-5 * scale:
            fail(f"K2 disagrees with autograd of the plain version "
                 f"(P{lvl + 2}, {label})")
        if not bool((d16 <= 2.0 ** -7 * ref16.abs() + 2e-5 * scale).all()):
            fail(f"K2's bf16 grads disagree with the reference (P{lvl + 2}, "
                 f"{label})")
        err_bwd = max(err_bwd, err32, err16)
        touched_cells += int((ref.abs().sum(-1) > 0).sum())
    return err_bwd, touched_cells


def check_roi_align(dev, report):
    from dgod_tpu_torch.ops import cuda_roi_align as K
    from dgod_tpu_torch.ops.roi_align import roi_align_plain
    from dgod_tpu_torch.utils.timing import device_time_ms

    rng = np.random.RandomState(0)
    shapes = level_shapes()
    feats32 = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32))
               .to(dev) for h, w in shapes]
    feats16 = [f.to(torch.bfloat16) for f in feats32]
    rois = {n: torch.from_numpy(make_rois(rng, n)).to(dev)
            for n in (N_TRAIN, N_TEST)}

    err_fwd = 0.0
    for n in (N_TRAIN, N_TEST):
        for name, feats in (("f32", feats32), ("bf16", feats16)):
            ref = roi_align_plain(feats, rois[n])
            got = K.roi_align_fwd_cuda(feats, rois[n])
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            print(f"K1 roi_align_fwd N={n} {name}: max_abs_err={err:.3e} "
                  f"(ref max {scale:.3f})")
            if not torch.isfinite(got).all() or err > 1e-5 * scale:
                fail(f"K1 disagrees with its plain version (N={n}, {name})")
            err_fwd = max(err_fwd, err)

    g = torch.from_numpy(rng.randn(B, N_TRAIN, 7, 7, C).astype(np.float32)
                         ).to(dev)
    err_bwd, touched_cells = hold_k2("adversarial RoIs", feats32,
                                     rois[N_TRAIN], g)
    # the autograd path returns what the direct call returns
    leaves16 = [f.detach().requires_grad_(True) for f in feats16]
    grads16 = torch.autograd.grad(
        K.roi_align_cuda(leaves16, rois[N_TRAIN]), leaves16, g)
    got16 = K.roi_align_bwd_cuda(feats16, rois[N_TRAIN], g)
    for a, b in zip(got16, grads16):
        if b.dtype != torch.bfloat16 or not torch.equal(a, b):
            fail("K2 through autograd differs from the direct call")
    del got16, grads16

    # times at the train shape (bf16 features, N=512); K2 is the whole
    # backward: the geometry pass and the tiled gather
    r = rois[N_TRAIN]
    k1_ms = device_time_ms(lambda: K.roi_align_fwd_cuda(feats16, r), dev)
    k1_plain = device_time_ms(lambda: roi_align_plain(feats16, r), dev,
                              iters=3)
    k2_ms = device_time_ms(lambda: K.roi_align_bwd_cuda(feats16, r, g), dev)
    out16 = roi_align_plain(leaves16, r)
    k2_plain = device_time_ms(lambda: torch.autograd.grad(
        out16, leaves16, g, retain_graph=True), dev, iters=3)
    k1_pred = device_time_ms(
        lambda: K.roi_align_fwd_cuda(feats16, rois[N_TEST]), dev)
    k1_issued = [device_time_ms(lambda n=n: K.roi_align_fwd_cuda(
        feats16, rois[n]), dev, queued=False) for n in (N_TRAIN, N_TEST)]
    print(f"K1 {k1_ms:.3f} ms (plain {k1_plain:.3f}; previous design "
          f"{PREVIOUS_MS['K1 train']:.3f}) at B={B} N={N_TRAIN} bf16; "
          f"{k1_pred:.3f} ms (previous design {PREVIOUS_MS['K1 predict']:.3f})"
          f" at N={N_TEST}; timed as issued, without the sleep: "
          f"{k1_issued[0]:.3f} / {k1_issued[1]:.3f} ms")
    fwd_count = lambda: K.fwd_launches  # noqa: E731
    expect_refused("K1 with a misaligned level", lambda: K.roi_align_fwd_cuda(
        [misaligned(feats16[0])] + feats16[1:], r), fwd_count)
    expect_refused("K1 with misaligned rois", lambda: K.roi_align_fwd_cuda(
        feats16, misaligned(r)), fwd_count)
    print(f"K2 {k2_ms:.3f} ms (plain autograd {k2_plain:.3f}; previous "
          f"design {PREVIOUS_MS['K2']:.3f}) at B={B} N={N_TRAIN} bf16")

    n_roi = B * N_TRAIN
    pooled_bytes = n_roi * 49 * C * 4
    feat_bytes = touched_cells * C * 2  # bf16 cells this run's RoIs touch
    grad_bytes = sum(B * h * w * C * 2 for h, w in shapes)  # bf16 grads
    k1_ops = n_roi * 49 * 4 * 8 * C  # 4 samples x 4 corners x (mul + add)
    report["K1"] = dict(ms=k1_ms, plain_ms=k1_plain, max_abs_err=err_fwd,
                        bytes=pooled_bytes + feat_bytes + n_roi * 16,
                        ops=k1_ops)
    report["K2"] = dict(ms=k2_ms, plain_ms=k2_plain, max_abs_err=err_bwd,
                        bytes=pooled_bytes + n_roi * 16 + grad_bytes,
                        ops=k1_ops)
    del out16, leaves16


def k3_check_inputs(anchors: torch.Tensor):
    """K3's check: gt [B,G,4] and valid [B,G] on the anchors' device, with
    0, G, 1, 3, 7, 20, 60 and 100 valid gt per image (319 in all), gt equal
    to anchors, a duplicate gt, junk in one image's padding and, in image
    4, a valid gt beyond every anchor (its best IoU is 0)."""
    rng = np.random.RandomState(1)
    R = anchors.shape[0]
    anc = anchors.cpu().numpy()
    gt = np.zeros((B, G, 4), np.float32)
    valid = np.zeros((B, G), bool)
    for b in range(B):
        n = [0, G, 1, 3, 7, 20, 60, 100][b]  # image 0: no valid GT
        xy = rng.uniform([-20, -20], [CANVAS[1], CANVAS[0]], (n, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(600), (n, 2)))
        gt[b, :n] = np.concatenate([xy, xy + wh], 1)
        valid[b, :n] = True
        if n >= 3:
            # boxes that exactly equal anchors (IoU 1 ties) and a duplicate
            # gt (ties across gt in the rescue and the argmax)
            gt[b, 0] = anc[rng.randint(R)]
            gt[b, 1] = anc[rng.randint(R)]
            gt[b, 2] = gt[b, 1]
    gt[3, 3:] = rng.uniform(0, 100, (G - 3, 4))  # padding with junk values
    far = anc[:, 2:].max(0) + 50
    gt[4, 6] = [far[0], far[1], far[0] + 100, far[1] + 60]
    return (torch.from_numpy(gt).to(anchors.device),
            torch.from_numpy(valid).to(anchors.device))


def check_iou_match(dev, anchors, report):
    from dgod_tpu_torch.ops import cuda_matchers as K
    from dgod_tpu_torch.ops.matchers import match_anchors_plain
    from dgod_tpu_torch.utils.timing import device_time_ms

    R = anchors.shape[0]
    gt_t, valid_t = k3_check_inputs(anchors)
    valid = valid_t.cpu().numpy()
    max_diff = 0
    for allow in (True, False):
        ref = match_anchors_plain(gt_t, valid_t, anchors, 0.7, 0.3, allow)
        got = K.iou_match_cuda(gt_t, valid_t, anchors, 0.7, 0.3, allow)
        torch.cuda.synchronize()
        n_diff = int((ref != got).sum())
        max_diff = max(max_diff, int((ref.long() - got.long()).abs().max()))
        print(f"K3 iou_match allow_low_quality_matches={allow}: {n_diff} "
              f"codes differ of {B * R}; fg={int((got >= 0).sum())} "
              f"between={int((got == -2).sum())}; image 4 (a gt beyond "
              f"every anchor) fg {int((got[4] >= 0).sum())}")
        if n_diff:
            fail(f"K3 codes differ from the plain version (allow={allow})")
        if not bool((got[0] == -1).all()):
            fail("K3: an image with no valid GT must be all BELOW_LOW")
        if allow and not bool((got[4] >= 0).all()):
            fail("K3: a valid gt of best 0 must rescue every anchor")
    ms = device_time_ms(lambda: K.iou_match_cuda(gt_t, valid_t, anchors, 0.7,
                                                 0.3, True), dev)
    issued = device_time_ms(lambda: K.iou_match_cuda(
        gt_t, valid_t, anchors, 0.7, 0.3, True), dev, queued=False)
    plain = device_time_ms(lambda: match_anchors_plain(
        gt_t, valid_t, anchors, 0.7, 0.3, True), dev, iters=3)
    # the ops these inputs need: the intersection test (two min, two max,
    # two subtractions, two compares) for every valid (gt, anchor) pair,
    # and the rest of the IoU and the max (12 more, one division) for each
    # pair that intersects
    n_pairs = n_hits = 0
    for b in range(B):
        g = gt_t[b][valid_t[b]][:, None]
        iw = (torch.minimum(g[..., 2], anchors[:, 2])
              - torch.maximum(g[..., 0], anchors[:, 0]))
        ih = (torch.minimum(g[..., 3], anchors[:, 3])
              - torch.maximum(g[..., 1], anchors[:, 1]))
        n_hits += int(((iw > 0) & (ih > 0)).sum())
        n_pairs += g.shape[0] * R
        del iw, ih
    print(f"K3 {ms:.3f} ms (plain {plain:.3f}; previous design "
          f"{PREVIOUS_MS['K3']:.3f}) at B={B} G={G} R={R}, "
          f"{int(valid.sum())} valid gt; timed as issued, without the sleep: "
          f"{issued:.3f} ms; {n_hits} of {n_pairs} valid pairs intersect")
    expect_refused("K3 with a misaligned gt view", lambda: K.iou_match_cuda(
        misaligned(gt_t), valid_t, anchors, 0.7, 0.3, True),
        lambda: K.launches)
    expect_refused("K3 with misaligned anchors", lambda: K.iou_match_cuda(
        gt_t, valid_t, misaligned(anchors), 0.7, 0.3, True),
        lambda: K.launches)
    report["K3"] = dict(ms=ms, plain_ms=plain, max_abs_err=max_diff,
                        bytes=B * G * 17 + R * 16 + B * R * 4,
                        ops=8 * n_pairs + 12 * n_hits)


def fcos_match_gt(rng: np.random.RandomState, anchors: np.ndarray, counts):
    """GT [B,G,4], valid [B,G] for K4's check: image 0 has no valid gt and
    junk in its padding; image 1 all G valid; image 2 pairs of gt around
    shared anchors whose areas differ by less than 8 px^2 (and exact
    duplicates); image 3 gt whose largest distance to an anchor's centre
    lies exactly on its level's lower or upper bound; the rest ordinary gt,
    some equal to anchors, with junk in the padding."""
    H, W = CANVAS
    starts = np.cumsum((0,) + tuple(counts))
    gt = rng.uniform(-1e4, 1e4, (B, G, 4)).astype(np.float32)  # junk
    valid = np.zeros((B, G), bool)

    def ordinary(n):
        xy = rng.uniform([-20, -20], [W, H], (n, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(900), (n, 2)))
        return np.concatenate([xy, xy + wh], 1)

    gt[1] = ordinary(G)
    valid[1] = True
    pairs = []
    for _ in range(G // 2):  # near-tie pairs
        c = anchors[rng.randint(len(anchors))]
        cx, cy = 0.5 * (c[0] + c[2]), 0.5 * (c[1] + c[3])
        w, h = rng.uniform(40, 500, 2)
        a = np.array([cx - w * rng.uniform(0.2, 0.8), cy - h * rng.uniform(
            0.2, 0.8), 0, 0], np.float64)
        a[2:] = a[:2] + (w, h)
        e = rng.choice([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 7.0, 7.9])
        twin = a.copy()
        twin[2] += e / h  # the area grows by ~e px^2
        pairs += [a, twin] if rng.rand() < 0.5 else [twin, a]
    gt[2] = np.array(pairs[:G], np.float32)
    valid[2] = True
    bounds = []
    for lvl in range(len(counts)):  # largest distance == lower or upper
        for _ in range(G // (2 * len(counts))):
            c = anchors[rng.randint(starts[lvl], starts[lvl + 1])]
            s = c[2] - c[0]
            cx, cy = 0.5 * (c[0] + c[2]), 0.5 * (c[1] + c[3])
            bounds.append([cx - 4 * s, cy - 2 * s, cx + 2 * s, cy + 2 * s])
            bounds.append([cx - 2 * s, cy - 2 * s, cx + 2 * s, cy + 8 * s]
                          if rng.rand() < 0.5 else
                          [cx - 8 * s, cy - 2 * s, cx + 6 * s, cy + 2 * s])
    n = min(G, len(bounds))
    gt[3, :n] = np.array(bounds[:n], np.float32)
    valid[3, :n] = True
    for b, n in zip(range(4, B), (1, 7, 30, 100)):
        gt[b, :n] = ordinary(n)
        gt[b, 0] = anchors[rng.randint(len(anchors))]  # a gt equal to an anchor
        valid[b, :n] = True
    return gt, valid


def check_fcos_match(dev, report):
    from dgod_tpu_torch.models.fcos import fcos_anchors_for
    from dgod_tpu_torch.ops import cuda_matchers as K
    from dgod_tpu_torch.ops.matchers import fcos_match
    from dgod_tpu_torch.utils.timing import device_time_ms

    anchors_np, counts = fcos_anchors_for(CANVAS)
    R = anchors_np.shape[0]
    gt, valid = fcos_match_gt(np.random.RandomState(11), anchors_np, counts)
    anchors = torch.from_numpy(anchors_np).to(dev)
    gt_t = torch.from_numpy(gt).to(dev)
    valid_t = torch.from_numpy(valid).to(dev)
    max_diff = 0
    for exact in (False, True):
        ref = fcos_match(anchors, gt_t, valid_t, counts, 1.5, exact)
        got = K.fcos_match_cuda(anchors, gt_t, valid_t, counts, 1.5, exact)
        torch.cuda.synchronize()
        n_diff = int((ref != got).sum())
        max_diff = max(max_diff, int((ref.long() - got.long()).abs().max()))
        fg = (got >= 0).sum(1).tolist()
        print(f"K4 fcos_match exact_reference_area={exact}: {n_diff} codes "
              f"differ of {B * R}; fg per image {fg}")
        if n_diff:
            fail(f"K4 codes differ from the plain version (exact={exact})")
        if not bool((got[0] == -1).all()):
            fail("K4: an image with no valid GT must match nothing")
        if not all(fg[1:]):
            fail("K4: every image with gt must match some location")
    ms = device_time_ms(lambda: K.fcos_match_cuda(anchors, gt_t, valid_t,
                                                  counts), dev)
    plain = device_time_ms(lambda: fcos_match(anchors, gt_t, valid_t, counts),
                           dev, iters=3)
    issued = device_time_ms(lambda: K.fcos_match_cuda(anchors, gt_t, valid_t,
                                                      counts), dev,
                            queued=False)
    print(f"K4 {ms:.4f} ms (plain {plain:.3f}; previous design "
          f"{PREVIOUS_MS['K4']:.3f}) at B={B} G={G} R={R},"
          f" valid gt per image {valid.sum(1).tolist()}; timed as issued, "
          f"without the sleep: {issued:.4f} ms")
    # the work these inputs need: every test for each (image, valid gt,
    # anchor) pair whose anchor centre lies within the gt's centre window
    ctr = 0.5 * (anchors[:, :2] + anchors[:, 2:])
    rad = 1.5 * (anchors[:, 2] - anchors[:, 0])
    gctr = 0.5 * (gt_t[..., :2] + gt_t[..., 2:])
    near = ((ctr[None, None] - gctr[:, :, None]).abs().amax(-1)
            < rad[None, None]) & valid_t[..., None]
    n_near = int(near.sum())
    print(f"K4 bound's work: {n_near} (image, valid gt, anchor) pairs in a "
          f"centre window, of {R * int(valid.sum())} pairs")
    report["K4"] = dict(ms=ms, plain_ms=plain, max_abs_err=max_diff,
                        bytes=B * G * 17 + R * 16 + B * R * 4,
                        ops=25 * n_near)


def nms_candidates(rng: np.random.RandomState, K: int):
    """Per-class candidates of one predict, B rows of K: boxes clustered
    around a few objects (heavy overlap), labels 1..8, scores quantised to
    1/64 (many ties), ~20% invalid; row 1 keeps only 30 valid entries
    (fewer than k survivors), row 2 none."""
    H, W = CANVAS
    centres = rng.uniform([0, 0], [W, H], (B, 40, 2))
    pick = rng.randint(0, 40, (B, K))
    ctr = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(
        B, K, 2) * 12
    wh = np.exp(rng.uniform(np.log(8), np.log(400), (B, K, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    boxes = np.clip(boxes, 0, [W, H, W, H]).astype(np.float32)
    scores = (np.floor(rng.rand(B, K) * 64) / 64).astype(np.float32)
    labels = rng.randint(1, 9, (B, K))
    valid = rng.rand(B, K) > 0.2
    valid[1] = False
    valid[1, rng.choice(K, 30, replace=False)] = True
    valid[2] = False
    return boxes, scores, labels, valid


NMS_ROWS = ("three", "disjoint", "zeros", "empty")


def nms_adversarial(rng: np.random.RandomState, kind: str, K: int = 9000):
    """B rows of K candidates of one kind, as `nms_candidates` returns them:
    "three": every entry a copy of one of 3 boxes, jittered by up to 2 px,
    in one class, so 3 picks suppress the row and every rank must be
    passed; "disjoint": K mutually disjoint boxes in one class, so the
    first k ranks are the picks; "zeros": `nms_candidates`' boxes with
    scores +0.0 and -0.0 at random, all tied (the lower index first);
    "empty": nothing valid."""
    labels = np.ones((B, K), np.int64)
    valid = np.ones((B, K), bool)
    scores = rng.rand(B, K).astype(np.float32)
    if kind == "three":
        base = np.float32([[100, 100, 300, 250], [400, 200, 700, 500],
                           [800, 50, 1000, 400]])
        boxes = base[rng.randint(0, 3, (B, K))] + rng.uniform(-2, 2, (B, K, 4))
    elif kind == "disjoint":
        i = np.arange(K)
        x, y = (i % 100) * 12.0, (i // 100) * 7.0
        boxes = np.tile(np.stack([x, y, x + 10, y + 5], 1), (B, 1, 1))
    elif kind == "zeros":
        boxes, _, labels, valid = nms_candidates(rng, K)
        scores = np.where(rng.rand(B, K) < 0.5, -0.0, 0.0).astype(np.float32)
    elif kind == "empty":
        boxes, scores, labels, _ = nms_candidates(rng, K)
        valid[:] = False
    else:
        raise ValueError(kind)
    return boxes.astype(np.float32), scores, labels, valid


def nms_live_work(boxes, valid, scores, idx, ok, thr):
    """Live entries summed over the greedy rounds that picked something (an
    entry is live in round r until the pick of some round <= r suppresses
    it): the work of k argmax-and-suppress rounds, printed beside the bound
    so that designs compare."""
    from dgod_tpu_torch.ops.boxes import elementwise_iou

    picks = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    iou = elementwise_iou(picks[:, :, None, :], boxes[:, None, :, :])
    ar = torch.arange(boxes.shape[1], device=boxes.device)
    kill = ((iou > thr) | (ar[None, None] == idx[..., None])) & ok[..., None]
    k = idx.shape[1]
    rounds = torch.arange(k, device=boxes.device)[None, :, None]
    first = torch.where(kill, rounds, k).min(1).values  # [B, K]
    n_rounds = ok.sum(1, keepdim=True)
    live = valid & (scores > float("-inf"))
    return int((torch.minimum(first + 1, n_rounds) * live).sum())


def nms_needed_work(boxes, valid, scores, idx, ok, thr):
    """What this run's data needs of a greedy NMS cut at k picks, given its
    picks: (the entries that must be ranked, the IoU tests they need). The
    entries are every live one in an image with fewer than k picks, else
    those ranked at or above its last pick; each is tested against the
    picks ranked above it, in order, until one suppresses it (a pick
    itself against all of them)."""
    from dgod_tpu_torch.ops.boxes import elementwise_iou

    B_, K_ = scores.shape
    k = idx.shape[1]
    live = valid & (scores > float("-inf"))
    key = torch.where(live, scores + 0.0, float("-inf"))  # -0.0 ties +0.0
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(K_, device=scores.device).expand(B_, -1))
    picks = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    iou = elementwise_iou(picks[:, :, None, :], boxes[:, None, :, :])
    pick_rank = torch.gather(rank, 1, idx)
    above = ok[..., None] & (pick_rank[..., None] < rank[:, None, :])
    rounds = torch.arange(k, device=scores.device)[None, :, None]
    first = torch.where(above & (iou > thr), rounds, k).min(1).values
    tests = torch.where(first < k, first + 1, above.sum(1))
    last = torch.where(ok, pick_rank, -1).max(1, keepdim=True).values
    needed = live & ((ok.sum(1, keepdim=True) < k) | (rank <= last))
    return int(needed.sum()), int((tests * needed).sum())


def hold_k6(label, args, thr):
    """K6 against its plain version on `args` (class-offset boxes, scores,
    valid): idx and ok exactly equal. -> (idx, ok, greatest difference)."""
    from dgod_tpu_torch.ops import cuda_nms as K
    from dgod_tpu_torch.ops.nms import nms_topk_plain

    ref_idx, ref_ok, _ = nms_topk_plain(*args, thr, 100)
    idx, ok = K.nms_topk_cuda(*args, thr, 100)
    torch.cuda.synchronize()
    n_idx = int((idx != ref_idx).sum())
    n_ok = int((ok != ref_ok).sum())
    print(f"K6 nms_topk {label} iou={thr}: {n_idx} idx and {n_ok} ok differ "
          f"of {idx.numel()}; picks per image {ok.sum(1).tolist()}")
    if n_idx or n_ok:
        fail(f"K6 disagrees with its plain version ({label})")
    return idx, ok, max(int((idx - ref_idx).abs().max()), n_ok)


def check_nms_topk(dev, report):
    from dgod_tpu_torch.ops import cuda_nms as K
    from dgod_tpu_torch.ops.nms import _class_offsets, nms_topk_plain
    from dgod_tpu_torch.utils.timing import device_time_ms

    rng = np.random.RandomState(12)
    max_diff = 0
    # FRCNN predict: 1000 proposals x 9 classes at IoU 0.5; FCOS predict:
    # 1000 candidates on each of P3..P6 and 450 on P7 at IoU 0.6; then the
    # adversarial rows at the FRCNN shape
    rows = [(f"K={K_}", K_, thr, nms_candidates(rng, K_))
            for K_, thr in ((9000, 0.5), (4450, 0.6))]
    rows += [(kind, 9000, 0.5, nms_adversarial(rng, kind))
             for kind in NMS_ROWS]
    for label, K_, thr, arrays in rows:
        boxes, scores, labels, valid = (torch.from_numpy(a).to(dev)
                                        for a in arrays)
        off = _class_offsets(boxes, labels).contiguous()
        idx, ok, diff = hold_k6(label, (off, scores, valid), thr)
        max_diff = max(max_diff, diff)
        picks = ok.sum(1).tolist()
        want = {"three": [3] * B, "disjoint": [100] * B, "empty": [0] * B}
        if label in want and picks != want[label]:
            fail(f"K6: picks {picks} on the {label} rows")
        if label.startswith("K=") and (bool(ok[2].any()) or picks[1] > 30
                                       or not bool(ok[0].all())):
            fail("K6: wrong number of picks on the edge-case rows")
        if label == "disjoint" and not torch.equal(
                idx, torch.sort(scores, dim=1, descending=True, stable=True)[1]
                [:, :100]):
            fail("K6: the disjoint rows must pick their first 100 ranks")
        ms = device_time_ms(lambda: K.nms_topk_cuda(off, scores, valid, thr,
                                                    100), dev)
        plain = device_time_ms(lambda: nms_topk_plain(off, scores, valid, thr,
                                                      100), dev, iters=3)
        print(f"K6 {ms:.4f} ms (plain {plain:.3f}; previous design "
              f"{PREVIOUS_MS[f'K6 {label}']:.4f}) at B={B} K={K_} k=100, "
              f"{label} rows")
        # the bound: score and valid of every entry, the box of each entry
        # that must be ranked, 20 ops an IoU test, and the picks written;
        # beside it the k argmax rounds' count (20 ops a live entry a round)
        n_needed, n_tests = nms_needed_work(off, valid, scores, idx, ok, thr)
        bytes_ = B * K_ * 5 + 16 * n_needed + B * 100 * 9
        bound = max(bytes_ / HBM_BYTES_PER_S, 20 * n_tests / F32_FLOPS) * 1e3
        rounds = max(B * K_ * 21 / HBM_BYTES_PER_S, 20 * nms_live_work(
            off, valid, scores, idx, ok, thr) / F32_FLOPS) * 1e3
        print(f"K6 bound {bound:.6f} ms ({n_needed} entries ranked, {n_tests}"
              f" IoU tests); the argmax rounds' count {rounds:.6f} ms, "
              f"{label} rows")
        if K_ == 9000 and label.startswith("K="):  # the kernels line's row
            report["K6"] = dict(ms=ms, plain_ms=plain, bytes=bytes_,
                                ops=20 * n_tests)
    report["K6"]["max_abs_err"] = max_diff
    # the most entries per image its shared memory holds at k = 100: taken,
    # and one more refused before any launch
    K._kernel()
    limit = K._max_entries(100)
    boxes, scores, labels, valid = (torch.from_numpy(a[:1]).to(dev) for a in
                                    nms_candidates(rng, limit + 1))
    off = _class_offsets(boxes, labels).contiguous()
    hold_k6(f"K={limit} (the limit)", (off[:, :limit].contiguous(),
                                       scores[:, :limit].contiguous(),
                                       valid[:, :limit].contiguous()), 0.5)
    expect_refused(f"K6 at K={limit + 1}", lambda: K.nms_topk_cuda(
        off, scores, valid, 0.5, 100), lambda: K.launches)


TRAIN_LEVELS = (2000, 2000, 2000, 2000, 570)  # rpn top-k per level, training
PREDICT_LEVELS = (1000, 1000, 1000, 1000, 570)  # and at predict
RPN_NMS = 0.7


def proposal_inputs(rng: np.random.RandomState, levels):
    """K5's inputs at one main-path shape, in rank order per level: anchors
    of the RPN's sizes over the canvas; deltas ~0.5 randn with extremes
    (dw/dh beyond the log(1000/16) clamp, centres thrown off the image,
    sides under min_size); scores quantised to 1/4 (runs of exact ties);
    per level 16 nested pairs at adjacent ranks whose IoU lies within a few
    ulps of 0.7; image 0's last level all invalid (zero-area anchors);
    images of two sizes (clipping)."""
    H, W = CANVAS
    K = sum(levels)
    cx = rng.uniform(0, W, (B, K))
    cy = rng.uniform(0, H, (B, K))
    side = np.exp(rng.uniform(np.log(16), np.log(700), (B, K)))
    aspect = np.exp(rng.uniform(-0.7, 0.7, (B, K)))
    aw, ah = side * aspect, side / aspect
    anchors = np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2],
                       -1).astype(np.float32)
    deltas = (0.5 * rng.randn(B, K, 4)).astype(np.float32)
    deltas[:, ::17, 2:] = 8.0
    deltas[:, ::23, :2] = -6.0
    deltas[:, ::29, 2:] = -15.0
    scores = np.zeros((B, K), np.float32)
    start = 0
    for n in levels:
        s = np.floor(rng.randn(B, n) * 4) / 4
        scores[:, start:start + n] = -np.sort(-s, axis=1)
        for b in range(B):
            ranks = start + rng.choice(n // 2, 16, replace=False) * 2
            x0, y0 = rng.uniform(0, W / 2), rng.uniform(0, H / 2)
            for r in ranks:
                w, h = rng.uniform(10, 500), rng.uniform(10, 300)
                w2 = w * 0.7 * (1 + rng.uniform(-2e-6, 2e-6))
                anchors[b, r] = [x0, y0, x0 + w, y0 + h]
                anchors[b, r + 1] = [x0, y0, x0 + w2, y0 + h]
                deltas[b, r:r + 2] = 0.0
        start += n
    anchors[0, K - levels[-1]:] = [50, 50, 50, 50]
    sizes = np.tile(np.float32([600, 1200]), (B, 1))
    sizes[1::2] = [480, 1000]
    return deltas, anchors, scores, sizes


def greedy_keep(boxes, levels):
    """The plain NMS on given boxes: validity from small_box_mask and
    nms_mask_blocked per level in rank order (strictly decreasing scores)."""
    from dgod_tpu_torch.ops.boxes import small_box_mask
    from dgod_tpu_torch.ops.nms import nms_mask_blocked

    valid = small_box_mask(boxes, 1e-3)
    rank = -torch.arange(boxes.shape[1], device=boxes.device,
                         dtype=torch.float32).expand(boxes.shape[0], -1)
    keep, start = [], 0
    for n in levels:
        sl = slice(start, start + n)
        keep.append(nms_mask_blocked(boxes[:, sl], rank[:, sl], valid[:, sl],
                                     RPN_NMS))
        start += n
    return torch.cat(keep, 1), valid


def proposal_work(keep, valid, levels):
    """IoU tests this run's data needs: each kept box against every later
    valid box of its level."""
    n, start = 0, 0
    for size in levels:
        v = valid[:, start:start + size].long()
        later = v.flip(1).cumsum(1).flip(1) - v  # valid boxes after each
        n += int((later * keep[:, start:start + size]).sum())
        start += size
    return n


def hold_k5(label, got, ref_boxes, levels):
    """K5's outputs against the plain version: the keep mask must equal
    the plain NMS on the kernel's own boxes (0 differences), the boxes the
    plain decode to rtol 1e-6. -> (max abs error, kept count)."""
    boxes, keep = got
    ref_keep, valid = greedy_keep(boxes, levels)
    n_keep = int((keep != ref_keep).sum())
    err = float((boxes - ref_boxes).abs().max())
    n_box = int((boxes != ref_boxes).any(-1).sum())
    close = bool(((boxes - ref_boxes).abs()
                  <= 1e-6 * ref_boxes.abs()).all())
    print(f"K5 decode_nms {label}: {n_keep} keep flags differ of "
          f"{keep.numel()}; {n_box} boxes not bit-equal (max abs err "
          f"{err:.3e}); {int(keep.sum())} kept, {int(valid.sum())} valid")
    if n_keep or not close or not torch.isfinite(boxes).all():
        fail(f"K5 disagrees with its plain version ({label})")
    return max(err, float(n_keep)), keep, valid


def check_proposals(dev, report):
    from dgod_tpu_torch.ops import cuda_proposals as K
    from dgod_tpu_torch.ops.proposals import decode_nms_plain
    from dgod_tpu_torch.utils.timing import device_time_ms

    rng = np.random.RandomState(13)
    max_err = 0.0
    for name, levels in (("train", TRAIN_LEVELS), ("predict", PREDICT_LEVELS)):
        d, a, s, sz = (torch.from_numpy(x).to(dev)
                       for x in proposal_inputs(rng, levels))
        got = K.decode_nms_cuda(d, a, sz, levels, RPN_NMS)
        torch.cuda.synchronize()
        ref_boxes, ref_keep = decode_nms_plain(d, a, s, sz, levels, RPN_NMS)
        err, keep, valid = hold_k5(f"{name} K={sum(levels)}", got, ref_boxes,
                                   levels)
        max_err = max(max_err, err)
        n = levels[-1]
        if bool(keep[0, -n:].any()) or not bool(keep[1, -n:].any()):
            fail("K5: the all-invalid level kept something, or a valid one "
                 "nothing")
        print(f"  plain decode_nms keeps the same as the kernel: "
              f"{int((ref_keep != keep).sum())} flags differ")
        ms = device_time_ms(lambda: K.decode_nms_cuda(d, a, sz, levels,
                                                      RPN_NMS), dev)
        plain = device_time_ms(lambda: decode_nms_plain(d, a, s, sz, levels,
                                                        RPN_NMS), dev, iters=3)
        print(f"K5 {ms:.3f} ms (plain {plain:.3f}; previous design "
              f"{PREVIOUS_MS['K5 ' + name]:.3f}) at B={B} K={sum(levels)}")
        if name == "train":  # the row of the kernels line
            entries = B * sum(levels)
            report["K5"] = dict(
                ms=ms, plain_ms=plain,
                bytes=entries * (16 + 16 + 16 + 1) + B * 8,
                # ~30 ops per decoded entry, ~14 per IoU test
                ops=30 * entries + 14 * proposal_work(keep, valid, levels))
    report["K5"]["max_abs_err"] = max_err


# ViTDet-B's attentions at the cell's shapes, then two grids whose edges the
# kernels' 64-row tiles meet: 5 x 19 (rows padded to 32, 95 tokens, not a
# multiple of 64) and the global grid at batch 1 (fewer blocks than SMs):
# (batch of attentions, grid)
ATTENTIONS = {"window": (B * 18, (14, 14)), "global": (B, (38, 76)),
              "ragged 5x19": (3, (5, 19)), "global b1": (1, (38, 76))}
TIMED = ("window", "global")  # the shapes timed beside plain and SDPA
HEADS, HEAD_DIM = 12, 64
# K8's three kernels, as the profiler names them
K8_KERNELS = ("relpos_attn_bwd_delta", "relpos_attn_bwd_dkdv",
              "relpos_attn_bwd_dq")
# K7 and K8 on mma.sync fed by ldmatrix, the first design, at the timed
# shapes (this script, NVIDIA H100 80GB HBM3, 700 W)
PREVIOUS_ATTENTION_MS = {"K7 window": 0.226, "K8 window": 0.750,
                         "K7 global": 1.371, "K8 global": 4.993,
                         "relpos_attn_bwd_dkdv global": 3.24,
                         "relpos_attn_bwd_dq global": 1.77}


def attention_inputs(dev, n_att, grid, seed):
    """bf16 qkv [n_att, N, 3, 12, 64] and float32 q R_h, q R_w at ViTDet's
    magnitudes (unit q, k, v; logits of unit spread)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kh, kw = grid
    n = kh * kw
    qkv = torch.randn((n_att, n, 3, HEADS, HEAD_DIM), generator=gen,
                      device=dev).to(torch.bfloat16)
    rel = [0.5 * torch.randn((n_att, HEADS, n, k), generator=gen, device=dev)
           for k in grid]
    return qkv, rel[0], rel[1]


def kernel_device_ms(fn, names, iters: int = 10) -> dict:
    """Device ms per call of `fn` in the kernels whose names hold each of
    `names`, from torch.profiler's CUDA activity -> {name: ms, or None
    where the profiler saw no device time}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", None)
        if total is None:
            total = getattr(ev, "cuda_time_total", 0.0)
        for name in names:
            if name in ev.key:
                us[name] += total
    return {n: (t / iters / 1e3 if t > 0 else None) for n, t in us.items()}


def check_relpos_attention(dev, report):
    """K7 and K8 at the window, global and ragged shapes against the plain
    version in float32 (the truth) and in bf16 (the precision's own error):
    each output and gradient of the kernels lies no further from float32
    than twice the plain bf16 version's, or 1e-3 of its largest value, and
    through autograd it is the direct calls' bit for bit. Times at every
    shape, K8's delta, dK/dV and dQ kernels apart (torch.profiler), each
    beside its bound; at the timed shapes also the plain version's and
    SDPA's over the materialised bias. The global shape's (it dominates)
    is the kernels line's."""
    import torch.nn.functional as F

    from dgod_tpu_torch.ops import cuda_attention as K
    from dgod_tpu_torch.ops.attention import relpos_attention_plain
    from dgod_tpu_torch.utils.timing import device_time_ms

    scale = HEAD_DIM ** -0.5
    for name, (n_att, grid) in ATTENTIONS.items():
        qkv, rel_h, rel_w = attention_inputs(dev, n_att, grid, 0)
        n = qkv.shape[1]
        g = torch.randn((n_att, n, HEADS, HEAD_DIM), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1)
                        ).to(torch.bfloat16)
        ins = [qkv, rel_h, rel_w]
        leaves = {}
        for side, cast in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            xs = [qkv.to(cast).requires_grad_(True),
                  rel_h.clone().requires_grad_(True),
                  rel_w.clone().requires_grad_(True)]
            out = relpos_attention_plain(*xs, scale)
            grads = torch.autograd.grad(out, xs, g.to(out.dtype))
            leaves[side] = [out.detach().float()] + [t.float() for t in grads]
            del out, grads, xs
        out, lse = K.relpos_attention_fwd_cuda(qkv, rel_h, rel_w, scale)
        got = [out.float()] + [t.float() for t in K.relpos_attention_bwd_cuda(
            qkv, rel_h, rel_w, out, lse, g, scale)]
        torch.cuda.synchronize()
        errs = {}
        for what, a, truth, plain in zip(("out", "dqkv", "drel_h", "drel_w"),
                                         got, leaves["f32"], leaves["bf16"]):
            err = float((a - truth).abs().max())
            plain_err = float((plain - truth).abs().max())
            top = float(truth.abs().max())
            errs[what] = err
            print(f"K7/K8 {name} {what}: max_abs_err={err:.3e} (plain bf16 "
                  f"{plain_err:.3e}; largest {top:.3e})")
            if not torch.isfinite(a).all() \
                    or err > max(2 * plain_err, 1e-3 * top):
                fail(f"K7/K8 disagree with the plain version at the {name} "
                     f"shape ({what})")
        # through autograd as on the main path
        xs = [t.detach().requires_grad_(True) for t in ins]
        via = torch.autograd.grad(K.relpos_attention_cuda(*xs, scale), xs, g)
        for a, b in zip(via, got[1:]):
            if not torch.equal(a.float(), b):
                fail(f"K7/K8 through autograd differ from the direct calls "
                     f"({name})")
        del leaves, got, via
        fwd_ms = device_time_ms(lambda: K.relpos_attention_fwd_cuda(
            qkv, rel_h, rel_w, scale), dev)
        bwd_ms = device_time_ms(lambda: K.relpos_attention_bwd_cuda(
            qkv, rel_h, rel_w, out, lse, g, scale), dev)
        parts = kernel_device_ms(lambda: K.relpos_attention_bwd_cuda(
            qkv, rel_h, rel_w, out, lse, g, scale), K8_KERNELS)
        kh, kw = grid
        att = n_att * HEADS
        rel_bytes = att * n * (kh + kw) * 4
        flops = att * 2.0 * n * n * HEAD_DIM  # one product
        # bound: q, k, v (and the backward's output, its gradient and dq,
        # dk, dv) in bf16, q R_h, q R_w (and their gradients), the
        # log-sum-exp, against 2 (forward) or 5 (backward) products; of
        # K8's kernels, each against its own products (dK/dV: S^T, dP^T,
        # dV, dK; dQ: S, dP, dQ) or bytes (delta: O and dO read, delta
        # written)
        bounds = {
            "K7": max((att * n * (4 * HEAD_DIM * 2 + 4) + rel_bytes)
                      / HBM_BYTES_PER_S, 2 * flops / BF16_FLOPS),
            "K8": max((att * n * (8 * HEAD_DIM * 2 + 4) + 2 * rel_bytes)
                      / HBM_BYTES_PER_S, 5 * flops / BF16_FLOPS),
            "relpos_attn_bwd_delta": att * n * (2 * HEAD_DIM * 2 + 4)
            / HBM_BYTES_PER_S,
            "relpos_attn_bwd_dkdv": 4 * flops / BF16_FLOPS,
            "relpos_attn_bwd_dq": 3 * flops / BF16_FLOPS}
        plain_fwd = plain_bwd = lib_fwd = lib_bwd = None
        if name in TIMED:
            xs = [qkv.detach().requires_grad_(True), rel_h, rel_w]
            plain_fwd = device_time_ms(lambda: relpos_attention_plain(
                *xs, scale), dev, iters=3)
            plain_out = relpos_attention_plain(*xs, scale)
            plain_bwd = device_time_ms(lambda: torch.autograd.grad(
                plain_out, xs[0], g, retain_graph=True), dev, iters=3)
            del plain_out
            # SDPA, the library's fused attention, over the bias
            # materialised in bf16 (a float mask): q, k, v [n_att, heads,
            # N, D]
            idx = torch.arange(n, device=dev)
            bias = (rel_h[..., idx // kw] + rel_w[..., idx % kw]).to(
                torch.bfloat16)
            q, k, v = [t.detach().requires_grad_(True)
                       for t in qkv.permute(2, 0, 3, 1, 4).unbind(0)]
            lib_fwd = device_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), dev)
            lib_out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            gt = g.transpose(1, 2)
            lib_bwd = device_time_ms(lambda: torch.autograd.grad(
                lib_out, (q, k, v), gt, retain_graph=True), dev)
            del lib_out, bias, q, k, v
        for kid, ms, plain, lib in (("K7", fwd_ms, plain_fwd, lib_fwd),
                                    ("K8", bwd_ms, plain_bwd, lib_bwd)):
            bound = bounds[kid] * 1e3
            prev = PREVIOUS_ATTENTION_MS.get(f"{kid} {name}")
            print(f"{kid} {name} (B={n_att} N={n}): {ms:.3f} ms, bound "
                  f"{bound:.3f} ({100 * bound / ms:.1f}%)"
                  + (f"; plain {plain:.3f}, SDPA {lib:.3f}" if plain else "")
                  + (f"; first design {prev:.3f}" if prev else ""))
        for kname, ms in parts.items():
            bound = bounds[kname] * 1e3
            prev = PREVIOUS_ATTENTION_MS.get(f"{kname} {name}")
            share = "not measured" if ms is None else \
                f"{ms:.3f} ms ({100 * bound / ms:.1f}% of {bound:.3f})"
            print(f"  K8 {name} {kname}: {share}"
                  + (f"; first design {prev:.3f}" if prev else ""))
        if name == "global":
            report["K7"] = dict(ms=fwd_ms, plain_ms=plain_fwd,
                                library_ms=lib_fwd, max_abs_err=errs["out"],
                                bound_ms=bounds["K7"] * 1e3)
            report["K8"] = dict(ms=bwd_ms, plain_ms=plain_bwd,
                                library_ms=lib_bwd,
                                max_abs_err=max(errs["dqkv"], errs["drel_h"],
                                                errs["drel_w"]),
                                bound_ms=bounds["K8"] * 1e3)
        del qkv, rel_h, rel_w, out, lse, g
        torch.cuda.empty_cache()


# K9's leaf sets: (name, backbone, model family)
K9_SETS = (("ViTDet", "vitdet_b", "FRCNN"), ("FCOS", None, "FCOS"),
           ("FRCNN", None, "FRCNN"))
K9_MODES = (0, 2, 1)  # three updates: mixed step counts in the third


def k9_model(dev, family: str, backbone):
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel

    kw = dict(num_classes=9, num_domains=3, canvas=CANVAS,
              compute_dtype=torch.bfloat16, device=dev, seed=0)
    if backbone:
        kw["backbone"] = backbone
    return (DGFCOSModel if family == "FCOS" else DGFRCNNModel)(**kw)


def k9_grads(params, active, gen, update: int):
    """Gradients of one update as the main paths hand them: every 11th
    active leaf None, every other 4-D one channels_last, and in the third
    update the rest views of one flat buffer at a 4-byte offset (the
    data-parallel all-reduce's)."""
    names = [n for n, a in active.items() if a]
    dev = params[names[0]].device
    flat = None
    if update == 2:
        total = sum(params[n].numel() for n in names)
        flat = torch.randn(total + 1, generator=gen, device=dev) * 1e-3
    grads, offset = {}, 1
    for i, n in enumerate(names):
        p = params[n]
        if i % 11 == 0:
            continue
        if p.dim() == 4 and i % 2 == 0:
            grads[n] = (torch.randn(p.shape, generator=gen, device=dev)
                        * 1e-3).contiguous(memory_format=torch.channels_last)
        elif flat is not None:
            grads[n] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
        else:
            grads[n] = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
    return grads


def k9_state(params, config, gen):
    """Optimizer state as deep in training: moments drawn at Adam's scales
    and each leaf's step count drawn from 0-3,000."""
    from dgod_tpu_torch.train.optim import init_opt_state

    state = init_opt_state(params, config)
    if config.kind == "sgd":
        return state
    dev = next(iter(params.values())).device
    counts = torch.randint(0, 3001, (len(params),), generator=gen,
                           device=dev).tolist()
    for (n, p), c in zip(params.items(), counts):
        state["mu"][n] = torch.randn(p.shape, generator=gen, device=dev) * 1e-4
        state["nu"][n] = torch.rand(p.shape, generator=gen, device=dev) * 1e-8
        state["count"][n] = c
    return state


def k9_copy(params, state):
    return ({n: p.clone() for n, p in params.items()},
            {k: dict(v) if k == "count" else
             {n: t.clone() for n, t in v.items()} for k, v in state.items()})


def check_multi_tensor_update(dev, report):
    """K9 against its plain twin (train/optim.py::update_plain) on the real
    leaf sets of ViTDet-B and FCOS (Adam) and FRCNN (SGD): three updates
    through the masks of modes 0, 2 and 1 from a state deep in training
    (`k9_state`), with None, channels_last and misaligned gradients
    (`k9_grads`); every parameter, moment and count bit-identical. Then
    the mode-0 update of each set timed: K9, the plain loop on the device
    (queued) and as issued, torch.optim.Adam(fused=True) (the library's
    yardstick; the port never calls it), K9's bound (28 bytes an element
    for Adam, 12 for SGD). The ViTDet set's numbers are K9's report."""
    from dgod_tpu_torch.ops import cuda_optim
    from dgod_tpu_torch.train import optim
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.utils.timing import device_time_ms, host_ms

    for name, backbone, family in K9_SETS:
        model = k9_model(dev, family, backbone)
        config, lr = S.make_optimizer(
            family, model.detector.backbone if backbone else None)
        labels = model.param_group_labels()
        params = {n: p.detach() for n, p in model.named_parameters()}
        gen = torch.Generator(device=dev).manual_seed(9)
        state = k9_state(params, config, gen)
        plain_params, plain_state = k9_copy(params, state)
        before = cuda_optim.launches
        shapes = set()
        # FCOS's updates in launches of 7 leaves: the split over launches
        _, capacity = cuda_optim._kernel()
        cuda_optim._lib["capacity"] = 7 if name == "FCOS" else capacity
        for update, mode in enumerate(K9_MODES):
            active = S.build_active_mask(labels, mode)
            grads = k9_grads(params, active, gen, update)
            leaves = optim.active_leaves(params, grads, state, active, config)
            shapes |= {(g is None, None if g is None else g.is_contiguous(),
                        None if g is None else g.data_ptr() % 16)
                       for _, g, *_ in leaves}
            cuda_optim.multi_tensor_update(leaves, lr, config)
            optim.update_plain(optim.active_leaves(
                plain_params, grads, plain_state, active, config), lr, config)
        cuda_optim._lib["capacity"] = capacity
        launched = cuda_optim.launches - before
        torch.cuda.synchronize()
        for n in params:
            same = torch.equal(params[n], plain_params[n])
            if config.kind != "sgd":
                same = (same and torch.equal(state["mu"][n],
                                             plain_state["mu"][n])
                        and torch.equal(state["nu"][n], plain_state["nu"][n])
                        and state["count"][n] == plain_state["count"][n])
            if not same:
                fail(f"K9 {name}: {n} differs from the plain loop's")
        mode0 = optim.active_leaves(params, k9_grads(
            params, S.build_active_mask(labels, 0), gen, 0), state,
            S.build_active_mask(labels, 0), config)
        elements = sum(leaf.p.numel() for leaf in mode0)
        per = 12 if config.kind == "sgd" else 28
        bound = elements * per / HBM_BYTES_PER_S * 1e3
        ms = device_time_ms(lambda: cuda_optim.multi_tensor_update(
            mode0, lr, config), dev, iters=20)
        k9_host = host_ms(lambda: cuda_optim.multi_tensor_update(
            mode0, lr, config), dev)[1]
        plain_ms = device_time_ms(lambda: optim.update_plain(
            mode0, lr, config), dev, iters=1, warmup=1)
        plain_host = host_ms(lambda: optim.update_plain(mode0, lr, config),
                             dev)[1]
        lib_ms = None
        if config.kind != "sgd":
            lib = [leaf.p.clone() for leaf in mode0]
            for t, leaf in zip(lib, mode0):
                t.grad = (torch.zeros_like(t) if leaf.g is None else
                          leaf.g.clone(memory_format=torch.contiguous_format))
            adam = torch.optim.Adam(lib, lr=lr, betas=(config.b1, config.b2),
                                    eps=config.eps,
                                    weight_decay=config.weight_decay,
                                    fused=True)
            lib_ms = device_time_ms(adam.step, dev, iters=20)
            del adam, lib
        print(f"K9 {name} ({config.kind}): 3 updates bit-identical to the "
              f"plain loop over {len(params)} leaves, "
              f"{launched} launches, gradients "
              f"(None, contiguous, address % 16) {sorted(shapes, key=str)}; "
              f"mode 0: {len(mode0)} leaves, {elements} elements, "
              f"{ms:.4f} ms (as issued {k9_host:.3f}), bound {bound:.4f} "
              f"({100 * bound / ms:.1f}%); plain {plain_ms:.3f} ms on the "
              f"device, {plain_host:.3f} as issued; torch.optim.Adam fused "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms")
        if name == "ViTDet":
            report["K9"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                max_abs_err=0.0, bound_ms=bound)
        del model, params, state, plain_params, plain_state, mode0
        torch.cuda.empty_cache()


def check_small_model_card_vs_cpu(dev, family):
    """A small float32 model on the card (kernels) and on the CPU (plain
    versions), same weights, batch and draws: the losses must agree."""
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel, Draws, batch_to_torch
    from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig
    from dgod_tpu_torch.utils.synthetic import synthetic_batch

    canvas = (128, 256)
    kw = dict(num_domains=2, canvas=canvas, seed=3,
              compute_dtype=torch.float32, backbone_block_counts=(1, 1, 1, 1))
    if family == "FRCNN":
        kw["config"] = FRCNNConfig(
            rpn_pre_nms_train=256, rpn_pre_nms_test=256,
            rpn_post_nms_train=256, rpn_post_nms_test=256,
            rpn_batch_per_image=64, box_batch_per_image=64)
    cls = DGFRCNNModel if family == "FRCNN" else DGFCOSModel
    cpu_model = cls(device="cpu", **kw)
    gpu_model = cls(device=dev, **kw)
    batch = synthetic_batch(np.random.RandomState(2), 2, canvas, 2)
    draws = cpu_model.make_draws(2, G, torch.Generator().manual_seed(4))
    gpu_draws = None if draws is None else Draws(
        *[None if t is None else t.to(dev) for t in draws])
    for mode in range(5):
        l_cpu, _ = cpu_model.loss_for_mode(batch_to_torch(batch, "cpu"), draws,
                                           mode, REG_WEIGHTS)
        l_gpu, _ = gpu_model.loss_for_mode(batch_to_torch(batch, dev),
                                           gpu_draws, mode, REG_WEIGHTS)
        a, b = float(l_cpu.detach()), float(l_gpu.detach())
        print(f"small {family} mode {mode}: loss cpu {a:.6f} card {b:.6f}")
        if not np.isfinite(b) or abs(a - b) > 1e-3 * max(1.0, abs(a)):
            fail(f"small {family}: card and CPU losses differ in mode {mode}")


def snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def changed_groups(model, labels, before):
    changed = set()
    for n, p in model.named_parameters():
        if not torch.equal(before[n], p.detach()):
            changed.add(labels[n])
    return changed


def run_vitdet_phase(dev):
    """Phase 14: DG Faster R-CNN on ViTDet-B at full width (608x1216, bf16,
    batch 8, Adam at 1e-4, random weights from a seed): two DG cycles, each
    loss finite and each half launching K7 12 times and K8 12 times where
    it trains the backbone; the second cycle's images/s. Then the eval step
    at batch 1: the first call eager, the second captured as a CUDA graph,
    the third replayed; both graph calls give the eager detections bit for
    bit. -> the K7 and K8 launches of the cycles."""
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel, batch_to_torch
    from dgod_tpu_torch.ops import cuda_attention as K
    from dgod_tpu_torch.train import eval_graphs
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.optim import init_opt_state
    from dgod_tpu_torch.utils.synthetic import synthetic_batch

    t = time.perf_counter()
    model = DGFRCNNModel(num_classes=9, num_domains=3, canvas=CANVAS,
                         compute_dtype=torch.bfloat16, device=dev, seed=0,
                         backbone="vitdet_b")
    batch = batch_to_torch(synthetic_batch(np.random.RandomState(5), B,
                                           CANVAS, 3), dev)
    opt_config, lr = S.make_optimizer("FRCNN", model.detector.backbone)
    opt_state = init_opt_state(dict(model.named_parameters()), opt_config)
    steps = {k: S.make_pair_step(model, k, REG_WEIGHTS, opt_config, lr)
             for k in (1, 2, 3, 4)}
    gen = torch.Generator(device=dev).manual_seed(0)
    g = batch["boxes"].shape[1]
    launches = {"K7": 0, "K8": 0}
    for cycle in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, step in steps.items():
            before = (K.fwd_launches, K.bwd_launches)
            opt_state, metrics = step(
                opt_state, batch, model.make_draws(B, g, gen, True),
                model.make_draws(B, g, gen, False))
            got = (K.fwd_launches - before[0], K.bwd_launches - before[1])
            if got != (24, 12 if k == 2 else 24):
                fail(f"ViTDet pair (0,{k}) launched K7, K8 {got} times")
            launches["K7"] += got[0]
            launches["K8"] += got[1]
            losses = (float(metrics["loss0"]), float(metrics["loss"]))
            if not all(np.isfinite(losses)):
                fail(f"ViTDet pair (0,{k}): losses {losses}")
        torch.cuda.synchronize()
        img_s = 2 * B * len(steps) / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"ViTDet cycle {cycle}: {img_s:.1f} images/s, last losses "
              f"{losses}, peak {peak:.2f} GiB")
    one = {k: v[:1] for k, v in batch.items()
           if k in ("image", "image_size", "scale_back")}
    eval_step = S.make_eval_step(model)
    captures, replays = eval_graphs.graph_captures, eval_graphs.graph_replays
    eager = eval_step(one)
    served = [eval_step(one), eval_step(one)]
    if (eval_graphs.graph_captures - captures,
            eval_graphs.graph_replays - replays) != (1, 2):
        fail("ViTDet predict: the eval step did not serve from one graph")
    for got in served:
        for key, value in eager.items():
            if not torch.equal(got[key], value):
                fail(f"ViTDet predict: the graph's {key} differ from the "
                     f"eager call's")
    print(f"ViTDet predict at batch 1: the graph's replays give the eager "
          f"detections bit for bit ({int(eager['valid'].sum())} served); "
          f"phase {time.perf_counter() - t:.1f} s")
    del model, opt_state, steps, eval_step
    torch.cuda.empty_cache()
    return launches


def build_main_path(dev, family: str = "FRCNN"):
    """The full-width model of one family (phases 4-6) with its batch,
    optimizer state, fused pair steps (in the DG schedule's order) and eval
    step: `utils/synthetic.build_dg_cycle`, the bench's cycle, on one
    batch."""
    from dgod_tpu_torch.utils.synthetic import build_dg_cycle

    return build_dg_cycle(family, dev, canvas=CANVAS, batch=B)


def dg_cycle(path, before_pair=None, after_pair=None):
    """One DG cycle of fused pairs (0,k) and a predict on `path`, each pair
    synchronised (`utils/synthetic.run_dg_cycle`).

    `before_pair(k)` runs before pair (0,k) and its result is passed on as
    `after_pair(k, metrics, state, ms)` after it. Returns the host-clock ms
    of each synchronised pair step, that of the predict, and the
    detections."""
    from dgod_tpu_torch.utils.synthetic import run_dg_cycle
    from dgod_tpu_torch.utils.timing import host_ms

    batch = path.batches[0]
    pair_ms = {}

    def timed(k, metrics, state, ms):
        pair_ms[k] = ms
        if after_pair:
            after_pair(k, metrics, state, ms)

    run_dg_cycle(path, before_pair, timed, sync_pairs=True)
    dets, pred_ms = host_ms(lambda: path.eval_step(batch),
                            batch["image"].device)
    return pair_ms, pred_ms, dets


def reset_counts():
    from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms, cuda_proposals,
                                    cuda_roi_align)

    cuda_roi_align.fwd_launches = 0
    cuda_roi_align.bwd_launches = 0
    cuda_matchers.launches = 0
    cuda_matchers.fcos_launches = 0
    cuda_proposals.launches = 0
    cuda_nms.launches = 0


def read_counts():
    from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms, cuda_proposals,
                                    cuda_roi_align)

    return {"K1": cuda_roi_align.fwd_launches,
            "K2": cuda_roi_align.bwd_launches,
            "K3": cuda_matchers.launches,
            "K4": cuda_matchers.fcos_launches,
            "K5": cuda_proposals.launches,
            "K6": cuda_nms.launches}


def expected_launches(family: str, k=None):
    """Kernel launches of pair (0,k), or of a predict when k is None."""
    want = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    if k is None:  # predict: K5 the proposals, K1 pools them, K6 the NMS
        want.update(K1=1 if family == "FRCNN" else 0,
                    K5=1 if family == "FRCNN" else 0, K6=1)
    elif family == "FRCNN":
        # K2 runs in each half that backpropagates into the FPN: not in
        # mode 2, whose detector is frozen; K5 in each half's proposals
        want.update(K1=2, K2=1 if k == 2 else 2, K3=1, K5=2)
    else:  # one match per pair, shared by mode 0's loss and modes 2-4's
        want.update(K4=1)
    return want


class LastCalls:
    """While the main path runs, keep the arguments of the last call of
    each kernel wrapper (K1-K6), so that afterwards each kernel can be held
    against its plain version on the path's own inputs. The wrappers are
    called as before: each still counts its launch."""

    def __init__(self):
        from dgod_tpu_torch.ops import (cuda_matchers, cuda_nms,
                                        cuda_proposals, cuda_roi_align)

        self.targets = {"K1": (cuda_roi_align, "roi_align_fwd_cuda"),
                        "K2": (cuda_roi_align, "roi_align_bwd_cuda"),
                        "K3": (cuda_matchers, "iou_match_cuda"),
                        "K4": (cuda_matchers, "fcos_match_cuda"),
                        "K5": (cuda_proposals, "decode_nms_cuda"),
                        "K6": (cuda_nms, "nms_topk_cuda")}
        self.originals = {kid: getattr(m, name)
                          for kid, (m, name) in self.targets.items()}
        self.args = {}

    def __enter__(self):
        for kid, (module, name) in self.targets.items():
            def wrapped(*a, _kid=kid, **k):
                self.args[_kid] = (a, k)
                return self.originals[_kid](*a, **k)
            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for kid, (module, name) in self.targets.items():
            setattr(module, name, self.originals[kid])

    def check(self, family):
        """Each recorded call again, kernel against plain version."""
        from dgod_tpu_torch.ops.matchers import fcos_match, match_anchors_plain
        from dgod_tpu_torch.ops.nms import nms_topk_plain
        from dgod_tpu_torch.ops.proposals import decode_nms_plain
        from dgod_tpu_torch.ops.roi_align import roi_align_plain
        from dgod_tpu_torch.utils.timing import device_time_ms

        plain = {"K3": match_anchors_plain, "K4": fcos_match,
                 "K6": nms_topk_plain}
        for kid, (a, k) in sorted(self.args.items()):
            if kid == "K1":
                got = self.originals[kid](*a, **k)
                ref = roi_align_plain(*a, **k)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                print(f"{family} K1 on the main path's last inputs "
                      f"{tuple(got.shape)}: max_abs_err {err:.3e} (ref max "
                      f"{scale:.3f})")
                if not torch.isfinite(got).all() or err > 1e-5 * scale:
                    fail(f"{family}: K1 disagrees with its plain version on "
                         f"the main path's inputs")
                del got, ref
                continue
            if kid == "K2":
                hold_k2(f"{family} on the main path's last inputs", *a, **k)
                continue
            got = self.originals[kid](*a, **k)
            if kid == "K5":  # the rank order is the input order
                deltas, anchors, sizes, levels = a[:4]
                rank = -torch.arange(deltas.shape[1], dtype=torch.float32,
                                     device=deltas.device).expand(
                                         deltas.shape[0], -1)
                ref_boxes = decode_nms_plain(deltas, anchors, rank, sizes,
                                             levels, *a[4:], **k)[0]
                hold_k5(f"{family} on the main path's last inputs", got,
                        ref_boxes, levels)
                continue
            ref = plain[kid](*a, **k)
            if kid == "K6":
                ref, extra = ref[:2], f", {int(got[1].sum())} picks"
            else:
                got, ref = (got,), (ref,)
                extra = f", {int((got[0] >= 0).sum())} matched"
            n_diff = sum(int((x != y).sum()) for x, y in zip(got, ref))
            print(f"{family} {kid} on the main path's last inputs: {n_diff} "
                  f"outputs differ from the plain version{extra}")
            if n_diff:
                fail(f"{family}: {kid} disagrees with its plain version on "
                     f"the main path's inputs")
            if kid in ("K3", "K4", "K6"):
                dev = a[0].device
                ms = device_time_ms(lambda: self.originals[kid](*a, **k), dev)
                issued = device_time_ms(lambda: self.originals[kid](*a, **k),
                                        dev, queued=False)
                if kid == "K6":  # boxes, scores, valid
                    what = "live entries per image " + str(
                        (a[2] & (a[1] > float("-inf"))).sum(1).tolist())
                    prev = f"{PREVIOUS_MS['K6 K=9000']:.3f} at K=9000"
                else:  # K3: gt, valid, anchors; K4: anchors, gt, valid
                    what = "valid gt per image " + str(
                        a[1 if kid == "K3" else 2].sum(1).tolist())
                    prev = (f"{PREVIOUS_MS['K3']:.3f} at 319 gt" if kid == "K3"
                            else f"{PREVIOUS_MS['K4']:.3f} at the check")
                print(f"{family} {kid} on the main path's last inputs: "
                      f"{ms:.4f} ms, as issued without the sleep {issued:.4f}"
                      f" ms (previous design {prev}) at {what}")


def run_main_path(dev, family: str):
    """Phases 4-6 for one family: two full-width DG training cycles and
    predicts, with the kernels' launches counted from 0."""
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.utils import flops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    path = build_main_path(dev, family)
    model = path.model
    labels = model.param_group_labels()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{family}: {n_params} params, ResNet-50 (3,4,6,3), canvas "
          f"{CANVAS}, batch {B}, bf16 compute, {path.opt_config.kind} "
          f"lr {path.lr} wd {path.opt_config.weight_decay}")
    last = {}

    def before_pair(k):
        return snapshot(model), read_counts()

    def after_pair(k, metrics, state, ms):
        before, c0 = state
        c1 = last["counts"] = read_counts()
        vals = {n: float(v) for n, v in metrics.items()}
        bad = [n for n, v in vals.items() if not np.isfinite(v)]
        if bad:
            fail(f"{family} pair (0,{k}): non-finite losses {bad}")
        expect = set(S.MODE_ACTIVE_GROUPS[0]) | set(S.MODE_ACTIVE_GROUPS[k])
        got = changed_groups(model, labels, before)
        if got != expect:
            fail(f"{family} pair (0,{k}) moved groups {sorted(got)}, "
                 f"expected {sorted(expect)}")
        delta = {n: c1[n] - c0[n] for n in c1}
        want = expected_launches(family, k)
        if delta != want:
            fail(f"{family} pair (0,{k}) kernel launches {delta}, expected "
                 f"{want}")
        print(f"  pair (0,{k}): {ms:.1f} ms, loss0 {vals['loss0']:.4f} "
              f"loss{k} {vals['loss']:.6f}, moved {sorted(got)}, "
              f"launches {delta}")

    torch.cuda.synchronize()
    reset_counts()  # the family's main path starts here
    # two DG cycles and two predicts: the first of each pays cuDNN's and
    # the allocator's warm-up, the second's times are reported
    with LastCalls() as last_calls:
        for cycle in range(2):
            print(f"{family} cycle {cycle}:")
            pair_ms, pred_ms, dets = dg_cycle(path, before_pair, after_pair)
            c = read_counts()
            delta = {n: c[n] - last["counts"][n] for n in c}
            if delta != expected_launches(family):
                fail(f"{family} predict kernel launches {delta}, expected "
                     f"{expected_launches(family)}")
    counts = read_counts()  # and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    last_calls.check(family)
    shapes = {k: tuple(v.shape) for k, v in dets.items()}
    want_shapes = {"boxes": (B, 100, 4), "scores": (B, 100),
                   "labels": (B, 100), "valid": (B, 100)}
    if shapes != want_shapes:
        fail(f"{family} predict shapes {shapes}")
    if not (torch.isfinite(dets["boxes"]).all()
            and torch.isfinite(dets["scores"]).all()):
        fail(f"{family} predict: non-finite boxes or scores")
    lab = dets["labels"][dets["valid"]]
    # FRCNN: predictor columns 1..num_classes; FCOS: foreground ids 1..8
    n_cls = 9 if family == "FRCNN" else 8
    if lab.numel() and not bool(((lab >= 1) & (lab <= n_cls)).all()):
        fail(f"{family} predict: labels outside 1..{n_cls}")
    print(f"{family} predict: {pred_ms:.1f} ms, {int(dets['valid'].sum())} "
          f"detections, launches {delta}")
    print(f"{family} main path launches: {counts}; peak memory {peak:.1f} GiB")
    print(f"{family} pair steps ms: "
          f"{json.dumps({f'(0,{k})': v for k, v in pair_ms.items()})}; "
          f"predict ms: {pred_ms:.1f}")
    # the second cycle: 4 pairs, each counting its batch twice
    img_s = 2 * B * len(pair_ms) / (sum(pair_ms.values()) / 1e3)
    m = flops.train_mfu(family, CANVAS, B, img_s)
    print(f"{family} DG cycle (main path, second cycle, synchronised pairs): "
          f"{img_s:.2f} images/s, {m['model_tflops_per_sec']:.2f} model "
          f"TFLOP/s, mfu {m['mfu']:.4f} of {m['peak_tflops']:.1f} TFLOP/s "
          f"(utils.flops.train_mfu, {m['flops_per_image'] / 1e9:.1f} "
          f"GFLOP/image)")
    del path, model, dets
    return counts


# torchvision's names for the port's (utils/weights.py maps them back)
_TV_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
          "var": "running_var"}
COCO_CLASSES = 91


def torchvision_name(name: str, family: str) -> str:
    """A detector state_dict name -> the torchvision checkpoint's name
    (FRCNN as torchvision 0.8.2 spells it, FCOS as 0.13 does)."""
    import re

    m = re.fullmatch(r"backbone\.body\.layer(\d)_block(\d+)\.(.*)", name)
    if m:
        base, tail = f"backbone.body.layer{m[1]}.{m[2]}", m[3]
        c = re.fullmatch(r"Conv_(\d)\.weight", tail)
        if c:
            return f"{base}.conv{int(c[1]) + 1}.weight"
        if tail == "downsample_conv.weight":
            return f"{base}.downsample.0.weight"
        mod, leaf = tail.split(".")
        mod = "downsample.1" if mod == "downsample_bn" else mod
        return f"{base}.{mod}.{_TV_BN[leaf]}"
    if name.startswith("backbone.body.bn1."):
        return "backbone.body.bn1." + _TV_BN[name.split(".")[-1]]
    nest = "0." if family == "FCOS" else ""
    m = re.fullmatch(r"backbone\.fpn\.(lateral|output)(\d)\.(weight|bias)",
                     name)
    if m:
        blocks = "inner_blocks" if m[1] == "lateral" else "layer_blocks"
        return f"backbone.fpn.{blocks}.{m[2]}.{nest}{m[3]}"
    m = re.fullmatch(r"backbone\.p6p7\.(p6|p7)\.(weight|bias)", name)
    if m:
        return f"backbone.fpn.extra_blocks.{m[1]}.{m[2]}"
    m = re.fullmatch(r"head\.(cls|reg)_(conv|gn)(\d)\.(\w+)", name)
    if m:
        tower = {"cls": "classification_head", "reg": "regression_head"}
        i = 3 * int(m[3]) + (m[2] == "gn")
        leaf = {"scale": "weight"}.get(m[4], m[4])
        return f"head.{tower[m[1]]}.conv.{i}.{leaf}"
    for ours, tv in (("head.cls_logits", "head.classification_head"
                      ".cls_logits"),
                     ("head.bbox_reg", "head.regression_head.bbox_reg"),
                     ("head.bbox_ctrness", "head.regression_head"
                      ".bbox_ctrness"),
                     ("rpn_head", "rpn.head"),
                     ("box_head", "roi_heads.box_head"),
                     ("predictor", "roi_heads.box_predictor")):
        if name.startswith(ours + "."):
            return tv + name[len(ours):]
    if name.startswith("backbone.body."):
        return name  # the stem conv
    raise KeyError(f"no torchvision name for {name}")


def write_torchvision_file(detector, family: str, path: str,
                           imagenet: bool = False):
    """`detector`'s tensors as a torchvision checkpoint at `path`: COCO's
    class-dependent layers (91 classes, random from a seed), fc6's input
    flattened CHW, a BN step counter beside each BN, and for `imagenet` a
    plain resnet50 (the body with torchvision's prefix-free names and a
    1000-way fc). -> {torchvision name: the tensor written}."""
    gen = torch.Generator().manual_seed(91)
    sd = {}
    for name, t in detector.state_dict().items():
        if imagenet and not name.startswith("backbone.body."):
            continue
        t = t.detach().cpu().clone()
        tv = torchvision_name(name, family)
        if name == "box_head.fc6.weight":  # the port flattens HWC
            t = (t.reshape(t.shape[0], 7, 7, 256).permute(0, 3, 1, 2)
                 .reshape(t.shape[0], -1).contiguous())
        elif name.startswith("predictor.") or name.startswith(
                "head.cls_logits."):
            rows = COCO_CLASSES * (4 if "bbox_pred" in name else 1)
            t = torch.randn((rows,) + t.shape[1:], generator=gen) * 0.01
        key = sd_key(tv, imagenet)
        sd[key] = t
        if key.endswith("running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(1000)
    if imagenet:
        sd["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
        sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def sd_key(tv: str, imagenet: bool) -> str:
    """A plain resnet50 names its body's tensors without the prefix."""
    body = "backbone.body."
    return tv[len(body):] if imagenet and tv.startswith(body) else tv


def run_warm_start_phase(dev, family: str, root: str):
    """The torchvision warm start on the card, for one family: the
    calibrated init of one model, written as a torchvision checkpoint
    (FRCNN and FCOS as COCO detectors; FCOS also as an ImageNet resnet50),
    loaded by `train_driving_dg_torch.py --torch_weights` (`cli.main`,
    `--max_epochs 0`: the load, then the test sweep) into the CLI's own
    model (seed 42). Every ported tensor must equal the written one bit for
    bit, the class-dependent layers and (from the resnet50) everything
    outside the body must keep that model's init, the test mAP must lie in
    [0, 1], and a pair step (0,1) of the CLI's Trainer must be finite;
    counts from 0 around the CLI run and the pair step."""
    from dgod_tpu_torch import cli
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel, batch_to_torch
    from dgod_tpu_torch.utils.synthetic import (calibrate_frozen_bn,
                                                synthetic_batch)

    cls = {"FRCNN": DGFRCNNModel, "FCOS": DGFCOSModel}[family]
    batch = batch_to_torch(synthetic_batch(np.random.RandomState(8), B,
                                           CANVAS, 3), dev)
    source = cls(num_classes=9, num_domains=3, canvas=CANVAS, device=dev,
                 seed=1)
    calibrate_frozen_bn(source, batch["image"])
    source_sd = {k: v.detach().cpu().clone()
                 for k, v in source.detector.state_dict().items()}
    # the CLI's model before the load: the same draws on the CPU
    init = cls(num_classes=9, num_domains=3, canvas=CANVAS, device="cpu",
               seed=42).detector.state_dict()
    routes = [(family, False)] + ([("resnet", True)] if family == "FCOS"
                                  else [])
    want = {k: n + expected_launches(family, 1)[k]
            for k, n in expected_launches(family).items()}
    counts = dict.fromkeys(want, 0)
    for route, imagenet in routes:
        path = os.path.join(root, f"{family}_{route}.pth")
        written = write_torchvision_file(source.detector, family, path,
                                         imagenet)
        built = []

        class Capture(cli.Trainer):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                built.append(self)

        argv = ["--model", family, "--exp", "dg", "--source_domains", "ABC",
                "--target_domains", "I", "--batch_size", str(B),
                "--eval_batch_size", str(B), "--data_root", root,
                "--weights_folder", os.path.join(root, f"warm_{route}"),
                "--weights_file", family, "--torch_weights", path,
                "--max_epochs", "0"]
        trainer_cls, cli.Trainer = cli.Trainer, Capture
        reset_counts()  # this path starts here
        try:
            t = time.perf_counter()
            result = cli.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
        finally:
            cli.Trainer = trainer_cls
        trainer = built[0]
        got = {k: v.detach().cpu()
               for k, v in trainer.model.detector.state_dict().items()}
        ported, kept, bad = 0, 0, []
        for name, t in got.items():
            # what was written is the source's tensor (fc6 permuted back)
            class_dep = (name.startswith("predictor.")
                         or name.startswith("head.cls_logits."))
            if (sd_key(torchvision_name(name, family), imagenet) in written
                    and not class_dep):
                want_t, ported = source_sd[name], ported + 1
            else:
                want_t, kept = init[name], kept + 1
            if not torch.equal(t, want_t):
                bad.append(name)
        stem = "backbone.body.conv1.weight"  # the two inits must differ
        if bad or ported == 0 or torch.equal(init[stem], source_sd[stem]):
            fail(f"warm start {family} from {route}: {len(bad)} tensors "
                 f"differ from what was written or kept, e.g. {bad[:3]}")
        map50 = float(result["map_50"])
        if not 0.0 <= map50 <= 1.0:
            fail(f"warm start {family} from {route}: test mAP {map50}")
        print(f"warm start {family} from a torchvision {route} checkpoint "
              f"({len(written)} tensors) through the CLI: {ported} ported "
              f"bit for bit, {kept} kept the model's init; test mAP@0.5 "
              f"{map50:.6f}; load and test {run_s:.1f} s")
        d0 = trainer.model.make_draws(B, G, trainer.gen, with_rpn=True)
        dk = trainer.model.make_draws(B, G, trainer.gen, with_rpn=False)
        _, metrics = trainer.pair_steps[1](trainer.opt_state, batch, d0, dk)
        vals = {n: float(v) for n, v in metrics.items()}
        delta = read_counts()  # and ends here
        if not all(np.isfinite(v) for v in vals.values()):
            fail(f"warm start {family} from {route}: non-finite pair step "
                 f"{vals}")
        if delta != want:
            fail(f"warm start {family}: launches {delta}, expected {want} "
                 f"(a predict and a pair)")
        print(f"  pair (0,1) from the warm start: loss0 {vals['loss0']:.4f} "
              f"loss1 {vals['loss']:.6f}; launches with the test sweep "
              f"{delta}")
        for kid, n in delta.items():
            counts[kid] += n
        del trainer, built
    del source
    return counts


def learn_launches(family: str):
    return ({"K1", "K2", "K3", "K5", "K6"} if family == "FRCNN"
            else {"K4", "K6"})


def learn_size(family: str):
    """The size at which `family` must learn. FCOS: the CPU learning
    test's (scripts/check_convergence_torch.py SMOKE: 120x240 in 128x256,
    8 images per domain, batch 4, blocks (1,1,1,1)), to train mAP@0.5 0.6
    within 60 epochs. FRCNN does not get there at that size, and neither
    does the JAX package (train mAP 0 after 60 epochs on the CPU: its 240
    steps all lie inside the 600-step warm-up). So FRCNN learns at MID
    (300x600 in 320x608, 16 images per domain, batch 8, blocks (3,4,6,3)),
    the smallest size at which the JAX package is known to reach 0.6 (on
    the CPU at epoch 98 of 100, PERF.md), to 0.6 within those 100
    epochs."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts"))
    import check_convergence_torch as cc

    return cc.SMOKE if family == "FCOS" else cc.MID


def run_learn_phase(dev, family: str, root: str):
    """The port learns on the card: `family`, non_dg, at `learn_size`,
    through the kernels, with the JAX convergence script's recipe: random
    weights from model seed 0, FrozenBatchNorm at identity (FRCNN with the
    script's 600-step LR warm-up). Counts from 0 around it; the
    transforms' geometry is restored after it."""
    size = learn_size(family)
    import check_convergence_torch as cc
    from dgod_tpu_torch.data import transforms as T

    saved = {k: getattr(T, k) for k in
             ("CANVAS", "TRAIN_SIZE", "MIN_SIZE", "MAX_SIZE", "MIN_AREA")}
    warmup = cc.FRCNN_WARMUP if family == "FRCNN" else 0
    reset_counts()  # this path starts here
    try:
        r = cc.run_one(family, False, warmup_steps=warmup, tmpdir=root,
                       device=dev, calibrate_bn=False, seed=0, **size)
    finally:
        for k, v in saved.items():
            setattr(T, k, v)
    counts = read_counts()  # and ends here
    print(f"learn {family} non_dg at {size['image_hw']} in "
          f"{size['canvas']}, blocks {size['block_counts']}, "
          f"{size['n_per_domain']} per domain, batch {size['batch_size']}: "
          f"best train mAP@0.5 {r['best_map_50']:.4f} in {r['epochs']} "
          f"of at most {size['max_epochs']} epochs, {r['steps']} steps, "
          f"{r['wall_s']} s; curve "
          f"{[e['map_50'] for e in r['curve']]}; launches {counts}")
    if not r["reached"]:
        fail(f"learn {family}: train mAP@0.5 {r['best_map_50']} < "
             f"{size['target']} after {r['epochs']} epochs")
    missing = [k for k in learn_launches(family) if counts[k] <= 0]
    if missing:
        fail(f"learn {family}: {missing} were not launched")
    return counts


MESH_VAL_BATCHES = 2


def mesh_cycle(dev, model, init, host, mesh, root):
    """One DG cycle (the four fused pairs, one host batch each) and a
    validation over MESH_VAL_BATCHES of them, through `Trainer` from
    `init`, with or without `mesh`; counts from 0 around them. -> the
    parameters, optimizer state, val mAP, each pair's host-clock ms and
    the launches."""
    from dgod_tpu_torch.train.harness import Trainer
    from dgod_tpu_torch.utils.synthetic import HostBatches
    from dgod_tpu_torch.utils.timing import host_ms

    model.load_state_dict(init)
    t = Trainer(model, HostBatches(host, dg=True),
                HostBatches(host[:MESH_VAL_BATCHES]), dg=True, seed=0,
                log_every=10 ** 9, device=dev, mesh=mesh,
                ckpt_path=os.path.join(root, "mesh.ckpt"))
    pair_ms = []
    for k, step in t.pair_steps.items():
        def timed(*a, _step=step):
            out, ms = host_ms(lambda: _step(*a), dev)
            pair_ms.append(ms)
            return out
        t.pair_steps[k] = timed
    torch.cuda.synchronize()
    reset_counts()  # this path starts here
    t.train_epoch()
    val_map = t.validate()["map_50"]
    counts = read_counts()  # and ends here
    state = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = [v.clone() for k in ("mu", "nu")
           for v in t.opt_state.get(k, {}).values()]
    return state, opt, val_map, pair_ms, counts


def tensors_diff(a, b) -> float:
    """Largest |a - b| over two lists/dicts of tensors (0.0: equal bit for
    bit, -0.0 against 0.0 aside)."""
    vals = a.values() if isinstance(a, dict) else a
    others = b.values() if isinstance(b, dict) else b
    return max(float((x - y).abs().max()) for x, y in zip(vals, others))


def bit_identical(a, b) -> bool:
    vals = a.values() if isinstance(a, dict) else a
    others = b.values() if isinstance(b, dict) else b
    return all(torch.equal(x, y) for x, y in zip(vals, others))


def run_mesh_family(dev, family: str, root: str):
    """The mesh phase of one family: its full-width model (calibrated
    init of seed 0, 4 synthetic batches of B) through `Trainer` twice
    without a mesh and once with the one-rank mesh, all three bit for
    bit alike."""
    import torch.distributed as dist

    from dgod_tpu_torch.parallel import mesh as mesh_lib
    from dgod_tpu_torch.utils.synthetic import synthetic_model

    model, host = synthetic_model(family, dev, canvas=CANVAS, batch=B,
                                  n_batches=4)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    plain = [mesh_cycle(dev, model, init, host, None, root)
             for _ in range(2)]
    one_rank = mesh_lib.parse_mesh_spec("auto")
    for group in (one_rank.data_group, one_rank.model_group):
        # NCCL makes a communicator at its first call: not in a pair's time
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
    mesh = mesh_cycle(dev, model, init, host, one_rank, root)
    want = dict.fromkeys(read_counts(), 0)
    for k in (1, 2, 3, 4):
        for kid, n in expected_launches(family, k).items():
            want[kid] += n
    for kid, n in expected_launches(family).items():
        want[kid] += MESH_VAL_BATCHES * n
    (a, a_opt, a_map, a_ms, _), (b, b_opt, b_map, b_ms, _) = plain
    m, m_opt, m_map, m_ms, m_counts = mesh
    plain_same = bit_identical(a, b) and bit_identical(a_opt, b_opt)
    mesh_same = bit_identical(m, a) and bit_identical(m_opt, a_opt)
    print(f"mesh {family}: one-rank NCCL DG cycle vs the plain Trainer "
          f"from the same init and batches (parameters and optimizer "
          f"state): plain-vs-plain "
          f"{'bit-identical' if plain_same else 'DIFFERENT'}, mesh-vs-plain "
          f"{'bit-identical' if mesh_same else 'DIFFERENT'}; val mAP plain "
          f"{a_map!r} / {b_map!r}, mesh {m_map!r}; pair ms plain "
          f"{[round(x, 1) for x in a_ms]} / {[round(x, 1) for x in b_ms]}, "
          f"mesh {[round(x, 1) for x in m_ms]}")
    print(f"mesh {family} launches: {m_counts}")
    if not plain_same:
        fail(f"mesh {family}: two plain cycles differ under deterministic "
             f"settings (max diff {tensors_diff(a, b):.3e})")
    if not mesh_same:
        fail(f"mesh {family}: the one-rank mesh cycle is not bit-identical "
             f"to the plain cycle (max diff {tensors_diff(m, a):.3e})")
    if not (m_map == a_map == b_map):
        fail(f"mesh {family}: val mAP {m_map} != the plain {a_map}, {b_map}")
    if m_counts != want:
        fail(f"mesh {family}: kernel launches {m_counts}, expected {want}")
    return m_counts


def run_mesh_phase(dev, root: str):
    """Multi-GPU training on this card: a one-rank NCCL group (a file
    store in `root`), each family through `Trainer(mesh=auto)` against
    the plain Trainer under deterministic cuDNN; then, with more than one
    card, scripts/check_multigpu_torch.py over all of them."""
    import subprocess

    import torch.distributed as dist

    from dgod_tpu_torch.parallel import multihost

    with deterministic():
        multihost.initialize(
            coordinator_address="file://" + os.path.join(root, "nccl_store"),
            num_processes=1, process_id=0)
        try:
            nccl = ".".join(map(str, torch.cuda.nccl.version()))
            print(f"mesh: one-rank group, backend {dist.get_backend()}, "
                  f"nccl {nccl}, cudnn.deterministic True, benchmark False")
            for family in ("FRCNN", "FCOS"):
                run_mesh_family(dev, family, root)
        finally:
            dist.destroy_process_group()
    n = torch.cuda.device_count()
    if n < 2:
        print("mesh: 1 card; the multi-card part (DP and TP over every "
              "card, scripts/check_multigpu_torch.py) was not run")
        return
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "check_multigpu_torch.py")
    subprocess.run([sys.executable, script, "--ranks", str(n - n % 2)],
                   check=True, timeout=900)


CLI_IMAGE = (600, 1200)
CLI_SPLITS = {("a", "train"): 16, ("b", "train"): 16, ("c", "train"): 16,
              ("a", "val"): 8, ("b", "val"): 8, ("c", "val"): 8,
              ("i", "val"): 8}


def write_cli_dataset(root: str) -> None:
    """The CLI's dataset in the layout of DOMAIN_SPECS, in the real
    datasets' formats: domains a, c and i as PNGs whose rows cycle through
    the five filters (smooth random backgrounds with 2-8 coloured boxes
    each, labels 1..8), domain b (BDD100K) as JPEGs, the BDD-sized
    fixtures with 2-8 random boxes each."""
    from dgod_tpu_torch.cli import DOMAIN_SPECS
    from dgod_tpu_torch.utils.synthetic import png_filtered

    rng = np.random.RandomState(21)
    H, W = CLI_IMAGE
    yy, xx = np.mgrid[0:H, 0:W]
    bdd = []
    for name in BDD_FIXTURES:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            bdd.append(f.read())
    for (letter, split), n in CLI_SPLITS.items():
        name, csv_tpl, root_tpl = DOMAIN_SPECS[letter]
        img_dir = os.path.join(root, root_tpl.format(split=split))
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(n):
            if letter == "b":
                fname = f"{name}_{split}_{i:03d}.jpg"
                with open(os.path.join(img_dir, fname), "wb") as f:
                    f.write(bdd[i % len(bdd)])
                rows.append((fname, *random_boxes(rng, 720, 1280)))
                continue
            c0, c1 = rng.randint(0, 256, (2, 3))
            t = (xx / W)[..., None]
            img = (c0 * (1 - t) + c1 * t).astype(np.uint8)
            img += rng.randint(0, 8, (H, W, 3)).astype(np.uint8)
            k = rng.randint(2, 9)
            boxes, labels = [], []
            for _ in range(k):
                w = rng.randint(W // 30, W // 3)
                h = rng.randint(H // 20, H * 5 // 12)
                x, y = rng.randint(0, W - w), rng.randint(0, H - h)
                img[y:y + h, x:x + w] = rng.randint(0, 256, 3)
                boxes.append(f"{x} {y} {x + w} {y + h}")
                labels.append(str(rng.randint(1, 9)))
            fname = f"{name}_{split}_{i:03d}.png"
            with open(os.path.join(img_dir, fname), "wb") as f:
                f.write(png_filtered(img, kinds=np.roll((0, 1, 2, 3, 4), i)))
            rows.append((fname, ";".join(boxes), ";".join(labels)))
        write_csv(os.path.join(root, csv_tpl.format(split=split)), rows)


def save_warm_start(dev, family: str, root: str, ckpt: str):
    """The calibrated random init, as the CLI builds the model, saved as the
    warm-start checkpoint with val_acc -inf (the reference's warm start,
    train_driving_dg.py:154-155)."""
    from dgod_tpu_torch.cli import DOMAIN_SPECS
    from dgod_tpu_torch.data.dataset import DrivingDataset
    from dgod_tpu_torch.data.loader import TrainLoader
    from dgod_tpu_torch.models.dg_fcos import DGFCOSModel
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.checkpoint import CheckpointStore
    from dgod_tpu_torch.train.optim import init_opt_state
    from dgod_tpu_torch.utils.synthetic import calibrate_frozen_bn

    _, csv_tpl, root_tpl = DOMAIN_SPECS["a"]
    data = DrivingDataset(os.path.join(root, csv_tpl.format(split="train")),
                          os.path.join(root, root_tpl.format(split="train")),
                          0)
    batches = TrainLoader(data, B, dg=False).epoch()
    images = next(batches)["image"]
    batches.close()
    cls = {"FRCNN": DGFRCNNModel, "FCOS": DGFCOSModel}[family]
    model = cls(num_classes=9, num_domains=3, canvas=CANVAS, device=dev,
                seed=42)
    calibrate_frozen_bn(model, torch.from_numpy(images).to(dev))
    opt_config, _ = S.make_optimizer(family)
    CheckpointStore(ckpt).save(
        -1, model.state_dict(),
        init_opt_state(dict(model.named_parameters()), opt_config),
        {"val_acc": -float("inf"), "epoch": -1})


def cli_launches(family: str):
    """Launches of one CLI epoch: 6 fused pairs (1,2,3,4,1,2) and 4
    predicts (3 validation batches, 1 test batch)."""
    want = expected_launches(family)
    want = {k: 4 * n for k, n in want.items()}
    for k in (1, 2, 3, 4, 1, 2):
        for kid, n in expected_launches(family, k).items():
            want[kid] += n
    return want


def run_cli_phase(dev, family: str, root: str, extra=()):
    """Phase 8 for one family: train_driving_dg_torch.py's main at full
    width on the card, with the flags `extra`, from the calibrated init
    (made once per family and kept in `root`), counts from 0 around it.
    -> the launch counts and the epoch's images/s."""
    from dgod_tpu_torch import cli
    from dgod_tpu_torch.train.checkpoint import CheckpointStore

    wdir = os.path.join(root, "_".join(
        [f"weights_{family}", *(a.strip("-") for a in extra)]))
    ckpt = os.path.join(wdir, "dg.ckpt")
    init_ckpt = os.path.join(root, f"init_{family}.ckpt")
    if not os.path.exists(init_ckpt):
        save_warm_start(dev, family, root, init_ckpt)
    os.makedirs(wdir)
    shutil.copy(init_ckpt, ckpt)
    init = CheckpointStore(init_ckpt).load_latest()[0]
    argv = ["--model", family, "--exp", "dg", "--source_domains", "ABC",
            "--target_domains", "I", "--batch_size", str(B),
            "--eval_batch_size", str(B), "--data_root", root,
            "--weights_folder", wdir, "--weights_file", "dg",
            "--metrics_path", os.path.join(wdir, "metrics.jsonl"), *extra]
    label = " ".join([f"CLI {family}", *extra])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()  # this slice's main path starts here
    with LastCalls() as last_calls:
        t = time.perf_counter()
        result = cli.main(argv + ["--max_epochs", "1"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    counts = read_counts()  # and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    last_calls.check(label)
    map50 = float(result["map_50"])
    print(f"{label}: test mAP@0.5 {map50:.6f}; per class "
          f"{np.round(result['map_per_class'], 4).tolist()}")
    if not (np.isfinite(map50) and 0.0 <= map50 <= 1.0):
        fail(f"{label}: test mAP@0.5 {map50} is not in [0, 1]")
    if counts != cli_launches(family):
        fail(f"{label}: launches {counts}, expected "
             f"{cli_launches(family)}")
    saved, _, meta = CheckpointStore(ckpt).load_latest()
    bad = [k for k, v in saved.items() if not torch.isfinite(v).all()]
    moved = [k for k in saved if not torch.equal(saved[k], init[k])]
    print(f"{label}: best checkpoint epoch {meta['epoch']} val_acc "
          f"{meta['val_acc']:.6f}; {len(moved)} of {len(saved)} tensors "
          f"moved from the init")
    if meta["epoch"] != 0 or bad or not moved:
        fail(f"{label}: checkpoint epoch {meta['epoch']}, non-finite "
             f"{bad[:3]}, moved {len(moved)}")
    with open(os.path.join(wdir, "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f
                  if '"scope": "epoch"' in line]
    img_s = epochs[-1]["images_per_sec"]

    t = time.perf_counter()
    with LastCalls() as rerun_calls:
        again = cli.main(argv + ["--max_epochs", "0"])
        torch.cuda.synchronize()
    test_s = time.perf_counter() - t
    diff = abs(float(again["map_50"]) - map50)
    # the last test batch's candidates (class-offset boxes, scores) as K6
    # got them in each run: the same weights must predict the same
    first, rerun = last_calls.args["K6"][0][:2], rerun_calls.args["K6"][0][:2]
    pred_diff = max(float((a - b).abs().max()) for a, b in zip(first, rerun))
    print(f"{label}: --max_epochs 0 rerun test mAP@0.5 "
          f"{float(again['map_50']):.6f} (diff {diff:.1e}); last test "
          f"batch's NMS candidates differ by {pred_diff:.1e}")
    if diff > 1e-6 or pred_diff > 1e-4:
        fail(f"{label}: the rerun from the checkpoint predicts "
             f"otherwise (mAP {diff}, candidates {pred_diff})")
    print(f"{label}: train {img_s:.2f} images/s (6 fused pairs of "
          f"{B}, each batch twice); fit+val+test {fit_s:.1f} s, rerun "
          f"(load + test) {test_s:.1f} s; peak memory {peak:.1f} GiB; "
          f"launches {counts}")
    return counts, img_s


# -- the data phase: cv2-free decode, ProcessTrainLoader, the stores ---------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "jpeg")
BDD_FIXTURES = ("bdd_720x1280.jpg", "bdd_720x1280_q90.jpg")
DATA_PNG = (1024, 2048)  # Cityscapes' (and the loader check's a and c)
DATA_PER_DOMAIN = 16
E2E_DATA = "e2e_png"  # the data phase's PNGs as bench_e2e_torch.py reads them


def msgpack_pack(obj) -> bytes:
    """msgpack of a tree the way flax.serialization.msgpack_serialize packs
    it (tests/test_torch_checkpoint.py holds the bytes to flax's): maps in
    sorted key order (jax's tree_map sorts them), lists, str, bytes, bool,
    None, int in its smallest form, float as float64, numpy arrays as ext
    1 and numpy scalars as ext 3 of msgpack (shape, dtype name, C bytes)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_header(out: bytearray, n: int, fix: int, fix_max: int, codes):
    if n <= fix_max:
        out.append(fix | n)
    elif n < 1 << 8 and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(o, out: bytearray) -> None:
    if isinstance(o, np.ndarray):
        body = msgpack_pack((list(o.shape), o.dtype.name,
                             np.ascontiguousarray(o).tobytes()))
        _pack_ext(1, body, out)
    elif isinstance(o, np.generic):
        body = msgpack_pack(((), o.dtype.name, np.asarray(o).tobytes()))
        _pack_ext(3, body, out)
    elif o is None:
        out.append(0xC0)
    elif o is True or o is False:
        out.append(0xC3 if o else 0xC2)
    elif isinstance(o, int):
        if 0 <= o < 0x80 or -32 <= o < 0:
            out += struct.pack(">b" if o < 0 else ">B", o)
        elif o >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32),
                                   (0xCF, ">Q", 1 << 64)):
                if o < top:
                    out += struct.pack(">B", code) + struct.pack(fmt, o)
                    break
        else:
            for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                                   (0xD1, ">h", -(1 << 15)),
                                   (0xD2, ">i", -(1 << 31)),
                                   (0xD3, ">q", -(1 << 63))):
                if o >= low:
                    out += struct.pack(">B", code) + struct.pack(fmt, o)
                    break
    elif isinstance(o, float):
        out += struct.pack(">Bd", 0xCB, o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        _pack_header(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(o, bytes):
        _pack_header(out, len(o), 0, -1, (0xC4, 0xC5, 0xC6))
        out += o
    elif isinstance(o, (list, tuple)):
        _pack_header(out, len(o), 0x90, 15, (None, 0xDC, 0xDD))
        for v in o:
            _pack(v, out)
    elif isinstance(o, dict):
        _pack_header(out, len(o), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(o):
            _pack(k, out)
            _pack(o[k], out)
    else:
        raise TypeError(f"msgpack_pack: {type(o).__name__}")


def _pack_ext(code: int, body: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(body) in fixed:
        out += struct.pack(">Bb", fixed[len(body)], code)
    else:
        _pack_header(out, len(body), 0, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
    out += body


def jax_layout(state_dict) -> dict:
    """The port's state_dict as the JAX package's parameter tree, keys
    sorted: the inverse of utils/weights.py::params_from_jax (OIHW ->
    HWIO, dense [out, in] -> [in, out], the DG banks' [D, in, out] as they
    are)."""
    tree = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)

    def ordered(node):  # keys sorted, as a jax tree_map leaves them
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node)}

    return ordered(tree)


def jax_ckpt_bytes(params_tree, opt_tree, meta) -> bytes:
    """A `.ckpt` as the JAX package's PickleStore writes it: a pickle of
    flax msgpack bytes of the parameter and optimizer trees, and `meta`
    with its step (dgod_tpu/train/checkpoint.py:35-44)."""
    import pickle

    return pickle.dumps({"params": msgpack_pack(params_tree),
                         "opt_state": msgpack_pack(opt_tree),
                         "meta": meta})


class deterministic:
    """cuDNN's deterministic algorithms and torch's, for a block whose runs
    must agree bit for bit; the settings before are restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark,
                      torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.saved[0]
        torch.backends.cudnn.benchmark = self.saved[1]
        torch.use_deterministic_algorithms(self.saved[2])


def check_decode(smi: str, root: str):
    """Data phase 1-3: build the C++ decode; every fixture JPEG (written
    with cv2, tests/fixtures/jpeg) decodes to the sha256 of cv2.imread's
    RGB recorded beside it; 1024x2048 PNGs using all five filters
    (`utils/synthetic.scene_pngs`, written into `root`/E2E_DATA as
    scripts/bench_e2e_torch.py writes its dataset) decode to their source
    arrays; the decode times. -> {"png": the PNGs' bytes and arrays}."""
    import hashlib

    from dgod_tpu_torch.data import jpeg, native, png
    from dgod_tpu_torch.utils.synthetic import scene_pngs, write_png_dataset
    from dgod_tpu_torch.utils.timing import host_ms

    _, ms = host_ms(native.IMAGE_DECODE.get, "cpu")
    print(f"data: built csrc/host/image_decode.cpp with g++ in {ms:.0f} ms")
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    for name, want in sorted(hashes.items()):
        img = jpeg.read_jpeg(os.path.join(FIXTURES, name))
        got = hashlib.sha256(img.tobytes()).hexdigest()
        if got != want["sha256"] or list(img.shape) != want["shape"]:
            fail(f"data: {name} decodes to {got[:12]} {img.shape}, cv2.imread "
                 f"gave {want['sha256'][:12]} {want['shape']}")
    print(f"data: {len(hashes)} fixture JPEGs (4:2:0, 4:2:2, 4:4:4, 4:4:0, "
          "odd sizes, restart intervals, grayscale, 720x1280) equal "
          "cv2.imread's recorded RGB hashes")

    t = time.perf_counter()
    made = list(scene_pngs(2 * DATA_PER_DOMAIN, DATA_PNG))
    encode_s = time.perf_counter() - t
    arrays = [m[1] for m in made]
    files = [m[2] for m in made]
    write_png_dataset(os.path.join(root, E2E_DATA), len(made), DATA_PNG,
                      made=made)
    t = time.perf_counter()
    for data, img in zip(files, arrays):
        if not np.array_equal(png.decode_png(data), img):
            fail(f"data: a filtered {DATA_PNG} PNG decodes otherwise than "
                 "its source")
    png_ms = (time.perf_counter() - t) * 1e3 / len(files)
    t = time.perf_counter()
    for data in files:
        png._inflate(data, "<bytes>")  # the chunks and zlib alone
    inflate_ms = (time.perf_counter() - t) * 1e3 / len(files)
    bdd = [open(os.path.join(FIXTURES, n), "rb").read() for n in BDD_FIXTURES]
    for data in bdd:  # warm
        jpeg.decode_jpeg(data)
    reps = 8
    t = time.perf_counter()
    for _ in range(reps):
        for data in bdd:
            jpeg.decode_jpeg(data)
    jpeg_ms = (time.perf_counter() - t) * 1e3 / (reps * len(bdd))
    (plain, plain_ms) = host_ms(lambda: png.decode_png_plain(files[0]), "cpu")
    if not np.array_equal(plain, arrays[0]):
        fail("data: the Python unfilter disagrees with the source")
    print(f"data: {len(files)} PNGs of {DATA_PNG} (rows cycling filters 0-4,"
          f" zlib level 1, {sum(map(len, files)) / len(files) / 2**20:.2f} "
          f"MiB each, made and encoded in {encode_s:.1f} s) decode to their "
          "sources")
    print(f"data: decode ms per image on the host (one thread; {smi}): C++ "
          f"PNG {DATA_PNG} {png_ms:.2f} (of which zlib's inflate "
          f"{inflate_ms:.2f}), C++ JPEG "
          f"720x1280 {jpeg_ms:.2f} (mean of the two BDD-sized fixtures, "
          f"{sum(map(len, bdd)) / len(bdd) / 1024:.0f} KiB each), Python "
          f"unfilter PNG {DATA_PNG} {plain_ms:.1f} (one image)")
    return {"png": list(zip(files, arrays)), "bdd": bdd}


def write_loader_dataset(root: str, decoded) -> str:
    """Data phase 4's dataset in DOMAIN_SPECS's layout: domains a and c
    the filtered 1024x2048 PNGs, b the BDD-sized fixture JPEGs (as the
    real datasets hold them), 2-8 random boxes per image. -> its root."""
    from dgod_tpu_torch.cli import DOMAIN_SPECS

    data_root = os.path.join(root, "loader_data")
    rng = np.random.RandomState(41)
    pngs = iter(decoded["png"])
    for letter in "abc":
        name, csv_tpl, root_tpl = DOMAIN_SPECS[letter]
        img_dir = os.path.join(data_root, root_tpl.format(split="train"))
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(DATA_PER_DOMAIN):
            if letter == "b":
                data, (H, W) = decoded["bdd"][i % 2], (720, 1280)
                fname = f"{name}_{i:03d}.jpg"
            else:
                data, img = next(pngs)
                (H, W), fname = img.shape[:2], f"{name}_{i:03d}.png"
            with open(os.path.join(img_dir, fname), "wb") as f:
                f.write(data)
            rows.append((fname, *random_boxes(rng, H, W)))
        write_csv(os.path.join(data_root, csv_tpl.format(split="train")),
                  rows)
    return data_root


def random_boxes(rng: np.random.RandomState, H: int, W: int):
    """2-8 boxes inside an HxW image, labels 1..8, as CSV cells."""
    boxes, labels = [], []
    for _ in range(rng.randint(2, 9)):
        w, h = rng.randint(W // 30, W // 3), rng.randint(H // 20, H * 5 // 12)
        x, y = rng.randint(0, W - w), rng.randint(0, H - h)
        boxes.append(f"{x} {y} {x + w} {y + h}")
        labels.append(str(rng.randint(1, 9)))
    return ";".join(boxes), ";".join(labels)


def write_csv(path: str, rows) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_name", "BoxesString", "LabelsString"])
        w.writerows(rows)


def batch_digest(batch) -> str:
    """sha256 over a batch's keys, shapes, dtypes and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        v = np.ascontiguousarray(batch[k])
        h.update(f"{k}{v.shape}{v.dtype}".encode())
        h.update(v.data)
    return h.hexdigest()


def run_loaders(root: str, decoded, smi: str):
    """Data phase 4: TrainLoader and ProcessTrainLoader (pinned copy-out)
    over the same mixed dataset, two DG epochs each (every batch twice);
    the batches must be bit-identical (their digests, so no batch outlives
    its step and the pinned blocks are reused, as in training) and the
    process loader's in pinned memory. -> images/s of each in the second
    epoch."""
    from dgod_tpu_torch.cli import DOMAIN_SPECS
    from dgod_tpu_torch.data.dataset import ConcatDataset, DrivingDataset
    from dgod_tpu_torch.data.loader import ProcessTrainLoader, TrainLoader

    data_root = write_loader_dataset(root, decoded)
    datasets = []
    for d, letter in enumerate("abc"):
        _, csv_tpl, root_tpl = DOMAIN_SPECS[letter]
        datasets.append(DrivingDataset(
            os.path.join(data_root, csv_tpl.format(split="train")),
            os.path.join(data_root, root_tpl.format(split="train")), d))
    data = ConcatDataset(datasets)
    rates, digests, first, pinned = {}, {}, {}, False
    for label, cls, kw in (("TrainLoader", TrainLoader, {}),
                           ("ProcessTrainLoader", ProcessTrainLoader,
                            {"pin_memory": True})):
        loader = cls(data, B, dg=True, seed=42, **kw)
        digests[label], rates[label] = [], []
        try:
            for _ in range(2):  # the first epoch starts a process loader
                t = time.perf_counter()
                for i, batch in enumerate(loader.epoch()):
                    if i == 0:
                        first.setdefault(label, time.perf_counter() - t)
                    if i == 0 and kw:  # the process loader's
                        pinned = all(torch.from_numpy(v).is_pinned()
                                     for v in batch.values())
                    digests[label].append(batch_digest(batch))
                rates[label].append((i + 1) * B / (time.perf_counter() - t))
        finally:
            if hasattr(loader, "close"):
                loader.close()
    a, b = digests["TrainLoader"], digests["ProcessTrainLoader"]
    same = len(a) == 4 * (len(data) // B) and a == b
    cores = len(os.sched_getaffinity(0))
    (t1, t2), (p1, p2) = rates["TrainLoader"], rates["ProcessTrainLoader"]
    print(f"data: loaders over {len(data)} images (a, c: PNG {DATA_PNG}; b: "
          f"JPEG (720, 1280)), batch {B}, two DG epochs ({len(a)} batches), "
          f"8 worker threads, {cores} host cores: images/s in epoch 2 "
          f"TrainLoader {t2:.2f}, ProcessTrainLoader {p2:.2f}; in epoch 1 "
          f"{t1:.2f} and {p1:.2f} (the process loader's spawn included; "
          f"first batch after {first['TrainLoader']:.2f} and "
          f"{first['ProcessTrainLoader']:.2f} s); "
          f"batches {'bit-identical' if same else 'DIFFERENT'}; the process "
          f"loader's batches in pinned memory: {pinned} ({smi})")
    if not same:
        fail("data: ProcessTrainLoader's batches differ from TrainLoader's")
    if not pinned:
        fail("data: ProcessTrainLoader(pin_memory=True) gave pageable arrays")
    return {"TrainLoader": t2, "ProcessTrainLoader": p2}


def run_directory_store(dev, root: str):
    """Data phase 5b: the CLI's FRCNN (its datasets, the calibrated init of
    the CLI phase, the process loader) through `Trainer` for one epoch into
    a `.ckpt` and into a directory store, under deterministic algorithms:
    the two checkpoints must hold the same bits and the two test reloads
    give the same mAP. Then a save into the directory store followed at
    once by an in-place change of every parameter on the card: the step
    written must hold the values before the change, and only that step
    may be left."""
    from dgod_tpu_torch import cli
    from dgod_tpu_torch.data.loader import EvalLoader, ProcessTrainLoader
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.train.checkpoint import (CheckpointStore,
                                                 DirectoryStore, make_store)
    from dgod_tpu_torch.train.harness import Trainer

    tr, _, vl, test = cli.datasets_from_arguments("abc", "i", root)
    init = CheckpointStore(os.path.join(root, "init_FRCNN.ckpt")
                           ).load_latest()[0]
    results = {}
    for kind, path in (("file", os.path.join(root, "store", "s.ckpt")),
                       ("directory", os.path.join(root, "store", "dir"))):
        model = DGFRCNNModel(num_classes=9, num_domains=3, canvas=CANVAS,
                             device=dev, seed=42)
        model.load_state_dict(init)
        with deterministic():
            trainer = Trainer(
                model, ProcessTrainLoader(tr, B, True, seed=42,
                                          pin_memory=True),
                EvalLoader(vl, B, False), dg=True, max_epochs=1,
                ckpt_path=path, seed=42, log_every=10 ** 9, device=dev)
            trainer.fit()
            result = trainer.test(EvalLoader(test, B, False))
        saved = make_store(path).load_latest()
        results[kind] = (float(result["map_50"]), saved)
        if kind == "directory":
            if not isinstance(trainer.store, DirectoryStore):
                fail(f"data: make_store({path!r}) is not a DirectoryStore")
            store, live = trainer.store, dict(model.state_dict())
    (m_file, (p_file, o_file, meta_file)), (m_dir, (p_dir, o_dir, meta_dir)) \
        = results["file"], results["directory"]
    same = (p_file.keys() == p_dir.keys()
            and all(torch.equal(p_file[k], p_dir[k]) for k in p_file))
    print(f"data: Trainer fit into a .ckpt and into a directory store, "
          f"deterministic: checkpoints {'bit-identical' if same else 'DIFFER'}"
          f" (epoch {meta_file['epoch']} / {meta_dir['epoch']}); test "
          f"reload mAP@0.5 {m_file!r} / {m_dir!r}")
    if not same or m_file != m_dir:
        fail("data: the directory store's checkpoint or test mAP differs "
             "from the .ckpt's")
    before = {k: v.detach().clone() for k, v in live.items()}
    store.save(7, live, {}, {"val_acc": 0.5, "epoch": 7})
    with torch.no_grad():  # queued at once behind the save's copy
        for v in live.values():
            v.add_(1.0)
    store.wait()
    got, _, meta = store.load_latest()
    kept = sorted(os.listdir(store.dir))
    intact = all(torch.equal(got[k], before[k].cpu()) for k in before)
    print(f"data: a save followed at once by an in-place change of every "
          f"tensor on the card wrote the values before it: {intact}; steps "
          f"left {kept}")
    if not intact or kept != ["7"] or meta["epoch"] != 7:
        fail("data: the directory store's asynchronous save is not a "
             "snapshot, or kept an older step")


def run_jax_ckpt(dev, root: str):
    """Data phase 6: the calibrated full-width FRCNN of the CLI phase
    written in the JAX package's `.ckpt` layout (`jax_ckpt_bytes`: flax
    msgpack in a pickle, SGD's empty state), loaded by the CLI's warm
    start (`--max_epochs 0`): every tensor equal to the written one, and
    one predict of the loaded model equal to the in-memory model's bit for
    bit."""
    from dgod_tpu_torch import cli
    from dgod_tpu_torch.data.loader import EvalLoader, to_tensor
    from dgod_tpu_torch.models.dg_frcnn import DGFRCNNModel
    from dgod_tpu_torch.train import steps as S
    from dgod_tpu_torch.train.checkpoint import CheckpointStore

    init = CheckpointStore(os.path.join(root, "init_FRCNN.ckpt")
                           ).load_latest()[0]
    wdir = os.path.join(root, "weights_jax")
    os.makedirs(wdir)
    with open(os.path.join(wdir, "jax.ckpt"), "wb") as f:
        f.write(jax_ckpt_bytes(jax_layout(init), {},
                               {"val_acc": -float("inf"), "epoch": -1,
                                "step": -1}))
    made = []

    class Recorded(cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    argv = ["--model", "FRCNN", "--exp", "dg", "--source_domains", "ABC",
            "--target_domains", "I", "--batch_size", str(B),
            "--eval_batch_size", str(B), "--data_root", root,
            "--weights_folder", wdir, "--weights_file", "jax",
            "--max_epochs", "0"]
    original, cli.Trainer = cli.Trainer, Recorded
    try:
        result = cli.main(argv)
    finally:
        cli.Trainer = original
    loaded = made[-1].model
    sd = loaded.state_dict()
    equal = sd.keys() == init.keys() and all(
        torch.equal(sd[k].cpu(), init[k]) for k in init)
    own = DGFRCNNModel(num_classes=9, num_domains=3, canvas=CANVAS,
                       device=dev, seed=0)
    own.load_state_dict(init)
    _, _, _, test = cli.datasets_from_arguments("abc", "i", root)
    batch = next(iter(EvalLoader(test, B, False)))
    placed = {k: to_tensor(v, dev) for k, v in batch.items()}
    with deterministic():
        a = S.make_eval_step(loaded)(placed)
        b = S.make_eval_step(own)(placed)
    same = all(torch.equal(a[k], b[k]) for k in ("boxes", "scores", "labels",
                                                 "valid"))
    print(f"data: a full-width FRCNN in the JAX .ckpt layout "
          f"({os.path.getsize(os.path.join(wdir, 'jax.ckpt')) / 2**20:.1f} "
          f"MiB) warm-started by the CLI: {len(init)} tensors equal to the "
          f"written ones: {equal}; one predict equal to the in-memory "
          f"model's bit for bit: {same}; test mAP@0.5 "
          f"{float(result['map_50']):.6f}")
    if not (equal and same):
        fail("data: the JAX .ckpt did not load bit for bit")


def run_data_phase(dev, root: str, smi: str, thread_cli):
    """Phase 12, the data path as the real datasets need it, without
    cv2: the decode (fixtures against cv2's hashes, filtered PNGs against
    their sources, times), the two train loaders, the CLI with
    --process_loader against the thread loader's run of phase 8, the
    directory store, and a JAX package .ckpt through the CLI's warm
    start. -> the process-loader CLI run's launches."""
    decoded = check_decode(smi, root)
    run_loaders(root, decoded, smi)
    counts, img_s = run_cli_phase(dev, "FRCNN", root, ["--process_loader"])
    print(f"data: CLI FRCNN epoch {img_s:.2f} images/s with "
          f"--process_loader, {thread_cli:.2f} with the thread loader "
          f"(phase 8, same data and init; {smi})")
    run_directory_store(dev, root)
    run_jax_ckpt(dev, root)
    return counts


# -- phase 13: the measurement entry points ----------------------------------

# what each counted call of a measurement script launches (counts in
# `calls`): a mode step alone (`mode_launches`), a pair (0,k)
# (`expected_launches`), a predict, and each prefix of the eval script's
# stage profile
STAGE_KERNELS = {"backbone+FPN": (), "+RPN heads": (),
                 "+proposal decode/NMS (K5)": ("K5",),
                 "+RoIAlign (K1)": ("K5", "K1"), "+box head": ("K5", "K1"),
                 "forward": ()}
# symbols of K1, K2, K3 and K5 in csrc/roi_align.cu, iou_match.cu and
# proposals.cu, as a profiler's trace names their launches
TRACE_SYMBOLS = {"K1": ("fwd_kernel",),
                 "K2": ("bwd_geometry_kernel", "bwd_gather_kernel"),
                 "K3": ("best_kernel", "match_kernel"),
                 "K5": ("decode_kernel", "mask_kernel", "scan_kernel")}


def mode_launches(family: str, mode: int):
    """Kernel launches of an unfused step of DG `mode` (the CLI's
    --reference_quirks path): FRCNN's mode 0 matches the RPN (K3); every
    mode pools (K1) the proposals (K5), and all but mode 2, whose detector
    is frozen, backpropagate into the FPN (K2). FCOS matches (K4) in every
    mode but 1, which reads no gt classes."""
    want = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    if family == "FRCNN":
        want.update(K1=1, K2=0 if mode == 2 else 1,
                    K3=1 if mode == 0 else 0, K5=1)
    else:
        want.update(K4=0 if mode == 1 else 1)
    return want


def launches_of(family: str, calls) -> dict:
    """The launches a measurement script's `calls` must have made."""
    want = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    for name, n in calls.items():
        if name == "predict" or name == "+postprocess (K6)":
            per = expected_launches(family)
        elif name.startswith("pair"):
            per = expected_launches(family, int(name[4:]))
        elif name.startswith("mode"):
            per = mode_launches(family, int(name[4:]))
        else:
            per = {k: 1 for k in STAGE_KERNELS[name]}
        for k, v in per.items():
            want[k] += n * v
    return want


def check_numbers(label: str, obj, path="") -> None:
    """Every number in a script's result finite, and positive but for a
    stage's difference of two times, the sweep's mAP (in [0, 1]), the
    losses and the decode cache's size (0: none); `None` stands where the
    script gives no number (a frozen stage's backward)."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            check_numbers(label, v, f"{path}.{k}")
        return
    if isinstance(obj, list):
        for i, v in enumerate(obj):
            check_numbers(label, v, f"{path}[{i}]")
        return
    if isinstance(obj, bool) or not isinstance(obj, (int, float)):
        return
    if not np.isfinite(obj):
        fail(f"{label}: {path} is {obj}")
    key = path.rsplit(".", 1)[-1]
    if key == "sweep_map_50":
        if not 0.0 <= obj <= 1.0:
            fail(f"{label}: {path} = {obj} is not in [0, 1]")
    elif (key not in ("stage_ms", "decode_cache_gb")
          and ".losses." not in path and obj <= 0):
        fail(f"{label}: {path} = {obj} is not positive")


def measured(label: str, family, fn):
    """`fn()` (a measurement script's run) with the kernels' counts from 0
    around it: its launches must be those of the calls it reports (per
    family, or, where the result has no `families`, of `family`), and its
    numbers pass `check_numbers`. Prints its result on a line of its own.
    -> the result."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = read_counts()
    want = dict.fromkeys(got, 0)
    for fam, part in (out.get("families") or {family: out}).items():
        for kid, n in launches_of(fam, part.get("calls", {})).items():
            want[kid] += n
    if got != want:
        fail(f"{label}: the kernels launched {got} times, its calls launch "
             f"{want}")
    check_numbers(label, out)
    print(f"measure {label}: {json.dumps(out)}")
    return out


def check_trace(path: str) -> dict:
    """The CUDA kernels a `profile_steps` trace names, per port kernel of
    TRACE_SYMBOLS. Fails unless each of K1, K2, K3 and K5 is there."""
    import re

    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {}
    for kid, symbols in TRACE_SYMBOLS.items():
        pat = re.compile(r"(?<![A-Za-z0-9_])(?:\d+)?(%s)\b"
                         % "|".join(symbols))
        found[kid] = sorted({m.group(1) for n in names
                             for m in [pat.search(n)] if m})
        if not found[kid]:
            fail(f"profile_steps: the trace names no kernel of {kid} "
                 f"({symbols}) among {len(names)} kernels")
    return found


def run_measure_phase(dev, root: str, smi: str) -> None:
    """Phase 13: each measurement script's card mode in a short setting,
    its kernels' launches counted from 0 around it and its numbers
    checked (`measured`): the e2e for FRCNN over the data phase's 1024x2048
    PNGs with threads and with the process loader, the eval of both
    families (batch 1 and 8, a 4-batch sweep whose mAP must equal a direct
    `Trainer.validate` of the same model on the same batches, both under
    deterministic algorithms, and the stage profile), the unfused mode
    steps of both, the roofline (every share and MFU at most 1.05); then
    one FRCNN pair inside `profile_steps`, whose trace must name the CUDA
    kernels of K1, K2, K3 and K5."""
    from argparse import Namespace

    from scripts import (bench_detail_torch, bench_e2e_torch,
                         bench_eval_torch, roofline_backbone_torch)

    from dgod_tpu_torch.utils import synthetic
    from dgod_tpu_torch.utils.logging import profile_steps

    t = time.perf_counter()
    e2e = {}
    for extra in ((), ("--process_loader",)):
        args = bench_e2e_torch.parse_args(
            ["--family", "FRCNN", "--steps", "12", "--images",
             str(2 * DATA_PER_DOMAIN), "--data_dir",
             os.path.join(root, E2E_DATA), *extra])
        label = "e2e " + ("ProcessTrainLoader" if extra else "TrainLoader")
        e2e[label] = out = measured(label, "FRCNN",
                                    lambda: bench_e2e_torch.run(args, dev))
        if out["dataset_write_s"] > 1.0:
            fail(f"{label}: wrote its PNGs anew ({out['dataset_write_s']:.1f}"
                 " s) instead of reading the data phase's")
        if out["occupancy"] > 1.05:
            fail(f"{label}: occupancy {out['occupancy']:.3f} > 1.05")
        if out["images"] != 12 * 2 * B:
            fail(f"{label}: {out['images']} images for 12 pairs of {B}")
    ns = Namespace(family="both", iters=3, sweep_batches=4)
    with deterministic():
        ev = measured("eval", None, lambda: bench_eval_torch.run(ns, dev))
        size = synthetic.SIZES["cuda"]
        for family, part in ev["families"].items():
            model, _ = synthetic.sized_model(family, dev, size)
            with tempfile.TemporaryDirectory() as sub:
                batches = bench_eval_torch.eval_batches(
                    ns.sweep_batches, size["batch"], size["canvas"])
                direct = bench_eval_torch.make_trainer(
                    model, batches, dev, sub).validate()["map_50"]
            if direct != part["sweep_map_50"]:
                fail(f"eval {family}: the sweep's mAP "
                     f"{part['sweep_map_50']} != a direct Trainer.validate's"
                     f" {direct}")
            print(f"eval {family}: the sweep's mAP {direct} equals a direct "
                  "Trainer.validate on the same batches (deterministic)")
            del model
    measured("detail", None, lambda: bench_detail_torch.run(
        Namespace(family="both", iters=2), dev))
    roof = measured("roofline", None, lambda: roofline_backbone_torch.run(
        Namespace(family="both", iters=3), dev))
    for row in roof["stages"]:
        for key in ("share", "fwd_bwd_mfu"):
            if row[key] is not None and row[key] > 1.05:
                fail(f"roofline {row['name']}: {key} {row[key]:.3f} > 1.05 "
                     "(a wrong count)")

    cycle = synthetic.build_dg_cycle("FRCNN", dev, canvas=CANVAS, batch=B)
    synthetic.run_dg_cycle(cycle)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with profile_steps(os.path.join(root, "profile")) as trace:
        k, step = next(iter(cycle.steps.items()))
        batch = cycle.batches[0]
        g = batch["boxes"].shape[1]
        cycle.opt_state, _ = step(
            cycle.opt_state, batch,
            cycle.model.make_draws(B, g, cycle.gen, with_rpn=True),
            cycle.model.make_draws(B, g, cycle.gen, with_rpn=False))
    if read_counts() != expected_launches("FRCNN", k):
        fail(f"profile_steps: pair (0,{k}) launched {read_counts()}, "
             f"expected {expected_launches('FRCNN', k)}")
    found = check_trace(trace)
    print(f"profile_steps: FRCNN pair (0,{k}) traced into "
          f"{os.path.getsize(trace) / 2**20:.1f} MiB; the trace names "
          f"{json.dumps(found)}")
    del cycle
    print(f"measure phase: {time.perf_counter() - t:.1f} s ({smi})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from dgod_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dgod_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    # cuBLAS's deterministic workspace (the Hopper default size), read at
    # its first use: the mesh phase runs with deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    # 1. the card
    from dgod_tpu_torch.utils.timing import card

    smi = card(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t:.1f} s")
    for name, log in _build.ptxas_report.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions
    from dgod_tpu_torch.models.faster_rcnn import FRCNNDetector

    anchors = FRCNNDetector(canvas=CANVAS, backbone_block_counts=(1, 1, 1, 1)
                            ).anchors.to(dev).contiguous()
    report = {}
    check_roi_align(dev, report)
    check_iou_match(dev, anchors, report)
    check_fcos_match(dev, report)
    check_nms_topk(dev, report)
    check_proposals(dev, report)
    check_relpos_attention(dev, report)
    check_multi_tensor_update(dev, report)
    for family in ("FRCNN", "FCOS"):
        check_small_model_card_vs_cpu(dev, family)

    # 4-7. the main path of each family: its counts are the kernels line's
    # launches; 8. the CLI of each family; 9. the torchvision warm start
    # of each; 10. each family learns. Phases 8-10 check their own
    # launches and print them on lines of their own
    from dgod_tpu_torch.ops import cuda_optim
    from dgod_tpu_torch.train import optim

    counts = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    k9_before = (cuda_optim.launches, optim.plain_leaves)
    for family in ("FRCNN", "FCOS"):
        for kid, n in run_main_path(dev, family).items():
            counts[kid] += n
    for kid, n in counts.items():
        if n <= 0:
            fail(f"{kid} was not launched on the main paths")
    counts.update(run_vitdet_phase(dev))
    counts["K9"] = cuda_optim.launches - k9_before[0]
    if optim.plain_leaves != k9_before[1] or counts["K9"] <= 0:
        fail(f"the main paths' updates took the plain loop "
             f"({optim.plain_leaves - k9_before[1]} leaves)")
    print(f"main paths' launches (the kernels line): {counts}")
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        run_mesh_phase(dev, root)
        print(f"mesh phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        write_cli_dataset(root)
        n_b = sum(n for (letter, _), n in CLI_SPLITS.items() if letter == "b")
        print(f"CLI dataset: {sum(CLI_SPLITS.values()) - n_b} PNGs of "
              f"{CLI_IMAGE} (rows cycling the five filters) and {n_b} JPEGs "
              f"of (720, 1280) (domain b) written in "
              f"{time.perf_counter() - t:.1f} s")
        cli_img_s = {}
        for family in ("FRCNN", "FCOS"):
            cli_counts, cli_img_s[family] = run_cli_phase(dev, family, root)
            print(f"CLI {family} launches: {cli_counts}")
        for family in ("FRCNN", "FCOS"):
            print(f"warm start {family} launches: "
                  f"{run_warm_start_phase(dev, family, root)}")
        t = time.perf_counter()
        data_counts = run_data_phase(dev, root, smi, cli_img_s["FRCNN"])
        print(f"CLI FRCNN --process_loader launches: {data_counts}; data "
              f"phase {time.perf_counter() - t:.1f} s")
        run_measure_phase(dev, root, smi)
        for family in ("FCOS", "FRCNN"):
            print(f"learn {family} launches: "
                  f"{run_learn_phase(dev, family, root)}")

    meta = {
        "K1": ("roi_align_fwd", "dgod_tpu_torch/csrc/roi_align.cu",
               "dgod_tpu/ops/pallas_roi_align.py:284"),
        "K2": ("roi_align_bwd", "dgod_tpu_torch/csrc/roi_align.cu",
               "dgod_tpu/ops/pallas_roi_align.py:472"),
        "K3": ("iou_match", "dgod_tpu_torch/csrc/iou_match.cu",
               "dgod_tpu/ops/pallas_matchers.py:94"),
        "K4": ("fcos_match", "dgod_tpu_torch/csrc/fcos_match.cu",
               "dgod_tpu/ops/pallas_matchers.py:202"),
        "K5": ("decode_nms", "dgod_tpu_torch/csrc/proposals.cu",
               "dgod_tpu/ops/pallas_proposals.py:37"),
        "K6": ("nms_topk", "dgod_tpu_torch/csrc/nms_topk.cu",
               "dgod_tpu/ops/pallas_nms.py:32"),
    }
    kernels = []
    for kid, (name, source, replaces) in meta.items():
        r = report[kid]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[kid],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    # K7, K8 at the global shape (B=8, N=2,888), bound by the tensor cores;
    # K9 on ViTDet's mode-0 leaves, bound by its bytes
    for kid, name, source, by in (
            ("K7", "relpos_attention_fwd", "relpos_attention.cu",
             "tensor cores"),
            ("K8", "relpos_attention_bwd", "relpos_attention.cu",
             "tensor cores"),
            ("K9", "multi_tensor_update", "multi_tensor_update.cu",
             "bytes")):
        r = report[kid]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"dgod_tpu_torch/csrc/{source}",
            "replaces": None, "launches": counts[kid],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": by, "library_ms": r["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
