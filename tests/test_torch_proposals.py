"""K5's plain version (`ops/proposals.decode_nms_plain`) against the JAX
package and a greedy NMS written out in numpy, and the port's
`generate_proposals` against JAX's.

- greedy NMS (numpy, float32, IEEE division) on the port's own decoded
  boxes, with exact score ties, a level whose boxes are all invalid and
  pairs whose IoU lies within 2 ulps of 0.7: keep masks equal exactly; the
  decode against JAX's to rtol 1e-6;
- JAX's XLA chain (delta_decode -> clip -> small-box mask ->
  nms_mask_blocked per image and level, `_xla_reference` of
  tests/test_pallas_proposals.py) and the TPU kernel
  `fused_decode_nms(..., interpret=True)` on the same kinds of input less
  the near-threshold pairs: keep masks exactly, boxes to rtol 1e-6. Within
  an ulp or two of the threshold neither decides as the IEEE division does:
  the TPU kernel tests inter > thr * union, and XLA:CPU's fused IoU rounds
  otherwise (ROADMAP Queue C); one pair shows the first;
- `generate_proposals` of both detectors on the same objectness and
  deltas, training and test: validity exact, boxes rtol 1e-6.

Boxes carry atol 1e-4 beside rtol 1e-6, as tests/test_torch_ops.py's
decode does: a coordinate that is the difference of two ~1e3 values keeps
their ulp (6e-5), and XLA:CPU contracts the decode otherwise than torch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgod_tpu.models.faster_rcnn import FRCNNConfig as JaxConfig
from dgod_tpu.models.faster_rcnn import FRCNNDetector as JaxDetector
from dgod_tpu.ops import boxes as j_box
from dgod_tpu.ops import nms as j_nms
from dgod_tpu.ops.pallas_proposals import fused_decode_nms
from dgod_tpu_torch.models.faster_rcnn import FRCNNConfig, FRCNNDetector
from dgod_tpu_torch.ops import boxes as t_box
from dgod_tpu_torch.ops.proposals import decode_nms, decode_nms_plain

THR = 0.7
HW = (640.0, 1280.0)


def _xla_reference(deltas, anchors, scores, sizes, thr):
    def per_image(dl, anc, sc, size):
        boxes = j_box.delta_decode(dl, anc)
        boxes = j_box.clip_boxes(boxes, size[0], size[1])
        ok = j_box.small_box_mask(boxes, 1e-3)
        keep = j_nms.nms_mask_blocked(boxes, sc, ok, thr)
        return boxes, keep

    return jax.vmap(per_image)(
        jnp.asarray(deltas), jnp.asarray(anchors), jnp.asarray(scores),
        jnp.asarray(sizes))


def _decoded(anchors):
    """The port's decode + clip of `anchors` under zero deltas."""
    a = torch.from_numpy(np.asarray(anchors, np.float32))
    b = t_box.delta_decode(torch.zeros_like(a), a)
    return t_box.clip_boxes(b, HW[0], HW[1]).numpy()


def _iou_tests(a, b):
    """(plain IoU > thr, division-free inter > thr * union) in float32."""
    f = np.float32
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]), f(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]), f(0))
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = (area_a + area_b) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, f(0))
    return iou > f(THR), inter > f(THR) * union, iou


def near_threshold_pairs(rng, n):
    """Anchor pairs [n, 2, 4] whose decoded boxes' IoU lies within 2 ulps
    of 0.7 (one box inside the other, widths ~0.7 apart), with the verdict
    of each IoU test."""
    f = np.float32
    m = 40 * n
    x0 = rng.uniform(0, 500, m).astype(f)
    y0 = rng.uniform(0, 300, m).astype(f)
    w = rng.uniform(10, 700, m).astype(f)
    h = rng.uniform(10, 300, m).astype(f)
    w2 = (w * 0.7 * (1 + rng.uniform(-2e-6, 2e-6, m))).astype(f)
    a = np.stack([x0, y0, x0 + w, y0 + h], 1)
    b = np.stack([x0, y0, x0 + w2, y0 + h], 1)
    da, db = _decoded(a), _decoded(b)
    div, free, iou = _iou_tests(da, db)
    ulps = np.abs(iou.view(np.int32) - f(THR).view(np.int32))
    pick = np.nonzero(ulps <= 2)[0][:n]
    assert len(pick) == n
    return np.stack([a[pick], b[pick]], 1), div[pick], free[pick]


def make_inputs(seed, b, level_sizes, near_pairs=True):
    """Rank-ordered per-level inputs: random anchors and deltas (some
    extreme: the log clamp, clipping to the image, boxes under min_size),
    runs of equal scores, near-threshold pairs at adjacent ranks (with
    `near_pairs`), and the last level of image 0 all invalid (zero-area
    anchors)."""
    rng = np.random.RandomState(seed)
    K = sum(level_sizes)
    h, w = HW
    cx = rng.uniform(0, w, (b, K))
    cy = rng.uniform(0, h, (b, K))
    aw = rng.uniform(4, 300, (b, K))
    ah = rng.uniform(4, 300, (b, K))
    anchors = np.stack([cx - aw / 2, cy - ah / 2, cx + aw / 2, cy + ah / 2],
                       -1).astype(np.float32)
    deltas = (0.2 * rng.randn(b, K, 4)).astype(np.float32)
    deltas[:, ::17, 2:] = 8.0  # beyond the log clamp
    deltas[:, ::23, :2] = -5.0  # far outside: clipped to the image edge
    deltas[:, ::29, 2:] = -15.0  # a side under min_size
    scores = np.zeros((b, K), np.float32)
    start = 0
    for n in level_sizes:
        s = np.floor(rng.randn(b, n) * 4) / 4  # quantised: runs of ties
        scores[:, start:start + n] = -np.sort(-s, axis=1)
        start += n
    n_pairs = max(1, min(level_sizes) // 8) if near_pairs else 0
    for i in range(b if near_pairs else 0):
        start = 0
        for n in level_sizes:
            pairs = near_threshold_pairs(rng, n_pairs)[0]
            ranks = start + rng.choice(n // 2, len(pairs), replace=False) * 2
            for (pa, pb), r in zip(pairs, ranks):
                anchors[i, r], anchors[i, r + 1] = pa, pb
                deltas[i, r:r + 2] = 0.0
            start += n
    anchors[0, K - level_sizes[-1]:] = [10, 10, 10, 10]  # all invalid
    sizes = np.tile(np.float32(HW), (b, 1))
    return deltas, anchors, scores, sizes


def _plain(deltas, anchors, scores, sizes, level_sizes):
    boxes, keep = decode_nms_plain(*map(torch.from_numpy, (
        deltas, anchors, scores, sizes)), level_sizes, THR)
    return boxes.numpy(), keep.numpy()


def _per_level(fn, deltas, anchors, scores, sizes, level_sizes):
    boxes, keep, start = [], [], 0
    for n in level_sizes:
        sl = slice(start, start + n)
        b, k = fn(deltas[:, sl], anchors[:, sl], scores[:, sl], sizes)
        boxes.append(np.asarray(b))
        keep.append(np.asarray(k))
        start += n
    return np.concatenate(boxes, 1), np.concatenate(keep, 1)


LEVELS = {"k128": (128, 128), "k570": (570, 96)}


def greedy_nms(boxes, valid, level_sizes):
    """Greedy NMS in rank order per (image, level), float32 with IEEE
    division: a valid box is kept unless a kept box before it overlaps it
    by IoU > 0.7."""
    keep = np.zeros(valid.shape, bool)
    for b in range(boxes.shape[0]):
        start = 0
        for n in level_sizes:
            bx = boxes[b, start:start + n]
            removed = ~valid[b, start:start + n]
            for i in range(n):
                if removed[i]:
                    continue
                keep[b, start + i] = True
                removed[i + 1:] |= _iou_tests(bx[i], bx[i + 1:])[0]
            start += n
    return keep


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_decode_nms_plain_is_greedy_nms(levels):
    level_sizes = LEVELS[levels]
    inputs = make_inputs(1, 2, level_sizes)
    boxes, keep = _plain(*inputs, level_sizes)
    valid = t_box.small_box_mask(torch.from_numpy(boxes), 1e-3).numpy()
    np.testing.assert_array_equal(keep, greedy_nms(boxes, valid, level_sizes))
    assert not keep[0, -level_sizes[-1]:].any()  # the all-invalid level
    assert keep[1, -level_sizes[-1]:].any()
    ref_boxes = _per_level(lambda *a: _xla_reference(*a, THR), *inputs,
                           level_sizes)[0]
    np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-6, atol=1e-4)
    # dispatch: a CPU tensor runs the plain version
    got = decode_nms(*map(torch.from_numpy, inputs), level_sizes, THR)
    np.testing.assert_array_equal(got[1].numpy(), keep)


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_decode_nms_plain_matches_the_xla_chain(levels):
    level_sizes = LEVELS[levels]
    inputs = make_inputs(2, 2, level_sizes, near_pairs=False)
    boxes, keep = _plain(*inputs, level_sizes)
    ref_boxes, ref_keep = _per_level(
        lambda *a: _xla_reference(*a, THR), *inputs, level_sizes)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-6, atol=1e-4)
    assert not keep[0, -level_sizes[-1]:].any()


@pytest.mark.parametrize("levels", sorted(LEVELS))
def test_decode_nms_plain_matches_the_tpu_kernel(levels):
    level_sizes = LEVELS[levels]
    inputs = make_inputs(3, 2, level_sizes, near_pairs=False)
    boxes, keep = _plain(*inputs, level_sizes)

    def tpu(d, a, s, sz):
        return fused_decode_nms(jnp.asarray(d), jnp.asarray(a),
                                jnp.asarray(s), jnp.asarray(sz),
                                iou_threshold=THR, interpret=True)

    ref_boxes, ref_keep = _per_level(tpu, *inputs, level_sizes)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_allclose(boxes, ref_boxes, rtol=1e-6, atol=1e-4)


def test_the_port_divides_where_the_tpu_kernel_does_not():
    """Pairs whose IoU the division-free test decides otherwise, one per
    image: the port keeps what greedy NMS with IEEE division keeps; the TPU
    kernel (in interpret mode on XLA:CPU, which rounds its own way within
    an ulp) departs from it on some of them, each time as the
    division-free test does."""
    rng = np.random.RandomState(3)
    pairs, div, free = near_threshold_pairs(rng, 4000)
    pick = np.nonzero(div != free)[0][:12]
    b, k = len(pick), 128
    anchors = np.zeros((b, k, 4), np.float32)  # the rest invalid
    anchors[:, :2] = pairs[pick]
    deltas = np.zeros((b, k, 4), np.float32)
    scores = np.tile(-np.arange(k, dtype=np.float32), (b, 1))
    sizes = np.tile(np.float32(HW), (b, 1))
    boxes, keep = _plain(deltas, anchors, scores, sizes, (k,))
    valid = t_box.small_box_mask(torch.from_numpy(boxes), 1e-3).numpy()
    np.testing.assert_array_equal(keep, greedy_nms(boxes, valid, (k,)))
    np.testing.assert_array_equal(keep[:, 1], ~div[pick])
    _, tpu_keep = fused_decode_nms(
        jnp.asarray(deltas), jnp.asarray(anchors), jnp.asarray(scores),
        jnp.asarray(sizes), iou_threshold=THR, interpret=True)
    differ = keep[:, 1] != np.asarray(tpu_keep)[:, 1]
    assert differ.any()
    np.testing.assert_array_equal(np.asarray(tpu_keep)[differ, 1],
                                  ~free[pick][differ])


CONFIG = dict(num_classes=9, rpn_pre_nms_train=512, rpn_pre_nms_test=256,
              rpn_post_nms_train=2000, rpn_post_nms_test=1000)
CANVAS = (128, 256)


@pytest.mark.parametrize("training", [True, False])
def test_generate_proposals_matches_jax(training):
    jd = JaxDetector(JaxConfig(**CONFIG), canvas=CANVAS,
                     backbone_block_counts=(1, 1, 1, 1))
    td = FRCNNDetector(FRCNNConfig(**CONFIG), canvas=CANVAS,
                       backbone_block_counts=(1, 1, 1, 1))
    rng = np.random.RandomState(4)
    b = 2
    obj = [(np.floor(rng.randn(b, n) * 8) / 8).astype(np.float32)
           for n in td.anchor_counts]  # many exact ties
    dl = [(0.3 * rng.randn(b, n, 4)).astype(np.float32)
          for n in td.anchor_counts]
    sizes = np.float32([[128, 256], [100, 200]])
    j_boxes, j_valid, j_scores = jd.generate_proposals(
        [jnp.asarray(o) for o in obj], [jnp.asarray(d) for d in dl],
        jnp.asarray(sizes), training)
    t_boxes, t_valid, t_scores = td.generate_proposals(
        [torch.from_numpy(o) for o in obj], [torch.from_numpy(d) for d in dl],
        torch.from_numpy(sizes), training)
    j_valid = np.asarray(j_valid)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    assert 0 < j_valid.sum() < j_valid.size
    np.testing.assert_allclose(t_boxes.numpy()[j_valid],
                               np.asarray(j_boxes)[j_valid], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(j_scores))


# -- K5's 64-rows-per-step scan (csrc/proposals.cu), modelled on the CPU ------

def k5_mask_words(boxes, valid, rng):
    """One level's IoU bitmask as K5's mask pass writes it: each block
    takes a row tile rt and column tiles rt + 4g .. rt + 4g + 3 of the upper
    triangle, enumerated as the kernel enumerates them; row i's word ct
    gets bit c when ct*64 + c > i and IoU > 0.7 (IEEE division). The words
    of invalid rows and below the diagonal are never written: they hold
    random bits here, as torch.empty leaves them."""
    n = len(boxes)
    words = -(-n // 64)
    m = rng.randint(0, 2 ** 62, (n, words)).astype(np.uint64)
    over = _iou_tests(boxes[:, None], boxes[None])[0]
    groups = [-(-(words - rt) // 4) for rt in range(words)]
    written = set()
    for block in range(sum(groups)):
        idx, rt = block, 0
        while rt < words and idx >= groups[rt]:
            idx -= groups[rt]
            rt += 1
        for ct in range(rt + 4 * idx, min(words, rt + 4 * idx + 4)):
            cols = np.arange(ct * 64, min(n, ct * 64 + 64))
            for i in range(rt * 64, min(n, rt * 64 + 64)):
                if valid[i]:
                    bits = over[i, cols] & (cols > i)
                    m[i, ct] = np.bitwise_or.reduce(
                        bits.astype(np.uint64) << (cols - ct * 64).astype(
                            np.uint64), initial=np.uint64(0))
                    written.add((i, ct))
    want = {(i, ct) for i in range(n) if valid[i]
            for ct in range(i // 64, words)}
    assert written == want  # the triangle, each word once
    return m


def k5_scan(m, valid):
    """K5's scan: the removed set starts as the invalid rows (and those
    past n); tile t is resolved row by row from the set's word t and the
    tile's 64 diagonal words, loaded whole (an invalid row's are random,
    and never used: the row starts removed), then the kept rows' later
    words are ORed into the set."""
    n, words = m.shape
    invalid = np.ones(words * 64, bool)
    invalid[:n] = ~valid
    removed = [int(sum(1 << j for j in range(64) if invalid[w * 64 + j]))
               for w in range(words)]
    keep = np.zeros(n, bool)
    for t in range(words):
        diag = [int(m[i, t]) if i < n else 0
                for i in range(t * 64, t * 64 + 64)]
        r, kept = removed[t], 0
        for j in range(64):
            if not (r >> j) & 1:
                kept |= 1 << j
                r |= diag[j]
        rows = [t * 64 + j for j in range(64) if (kept >> j) & 1]
        keep[rows] = True
        for w in range(t + 1, words):
            for i in rows:
                removed[w] |= int(m[i, w])
    return keep


@pytest.mark.parametrize("levels", sorted(LEVELS) + ["k200"])
def test_k5_scan_model_is_nms_mask_blocked(levels):
    """Near-0.7 nested pairs at adjacent ranks, runs of equal scores and
    an all-invalid level: the 64-rows-per-step scan over the kernel's
    bitmask keeps exactly what nms_mask_blocked keeps."""
    level_sizes = LEVELS.get(levels, (200, 64, 70))
    inputs = make_inputs(7, 2, level_sizes)
    boxes, keep = _plain(*inputs, level_sizes)
    valid = t_box.small_box_mask(torch.from_numpy(boxes), 1e-3).numpy()
    rng = np.random.RandomState(8)
    got = np.zeros_like(keep)
    for b in range(boxes.shape[0]):
        start = 0
        for n in level_sizes:
            sl = slice(start, start + n)
            m = k5_mask_words(boxes[b, sl], valid[b, sl], rng)
            got[b, sl] = k5_scan(m, valid[b, sl])
            start += n
    np.testing.assert_array_equal(got, keep)
    assert not got[0, -level_sizes[-1]:].any()  # the all-invalid level
    assert got[1, -level_sizes[-1]:].any()
    assert (valid & ~got).any()  # some valid box was suppressed
