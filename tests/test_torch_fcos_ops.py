"""Port parity of the FCOS slice's ops: the linear box coder, the FCOS
losses, the FCOS anchors, the centre-sampling matcher (kernel K4's plain
version) and first-k greedy NMS (kernel K6's plain version).

Same numpy inputs through dgod_tpu (JAX, CPU; the conftest pins the XLA
matcher) and dgod_tpu_torch (torch, CPU). Elementwise float results agree to
rtol 1e-6 (the same float32 operations in the same order); anchors, match
codes and NMS picks are exactly equal.

- The matcher runs on chip_smoke.py's hard cases at 608x1216 (no valid gt,
  junk in the padding, gt pairs whose areas differ by less than the 8 px^2
  ulp of 1e8 - area, largest distances exactly on a level's bound), for both
  `exact_reference_area` values, against the XLA matcher and against the
  Pallas kernel `fcos_match_tpu` in interpret mode.
- NMS: dgod_tpu's Pallas kernel `nms_topk_pallas` has no interpret flag
  (tests/test_pallas_nms.py ties it to `nms_topk` on a TPU only), so the
  port's plain version is held against `nms_topk`/`batched_nms_topk`, which
  that test holds the kernel to.
- GIoU: the port's forward is JAX's value for value; its gradient stays
  finite where the enclosing box is empty, where JAX's is NaN (a fault of
  the reference, ROADMAP Queue C).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from dgod_tpu.models import fcos as j_fcos
from dgod_tpu.ops import anchors as j_anchors
from dgod_tpu.ops import boxes as j_boxes
from dgod_tpu.ops import losses as j_losses
from dgod_tpu.ops import matchers as j_matchers
from dgod_tpu.ops import nms as j_nms
from dgod_tpu.ops import pallas_matchers as j_pallas_matchers
from dgod_tpu_torch.models import fcos as t_fcos
from dgod_tpu_torch.ops import anchors as t_anchors
from dgod_tpu_torch.ops import boxes as t_boxes
from dgod_tpu_torch.ops import cuda_matchers, cuda_nms
from dgod_tpu_torch.ops import losses as t_losses
from dgod_tpu_torch.ops import matchers as t_matchers
from dgod_tpu_torch.ops import nms as t_nms


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol, atol=atol)


def _unit_anchors(rng, n):
    ctr = rng.uniform(0, 500, (n, 2))
    size = rng.choice([8.0, 16.0, 32.0, 64.0, 128.0], (n, 1))
    return np.concatenate([ctr - size / 2, ctr + size / 2], 1).astype(
        np.float32)


# -- linear box coder ----------------------------------------------------------

def test_linear_coder_matches_jax():
    rng = np.random.RandomState(0)
    anchors = _unit_anchors(rng, 64)
    xy = rng.uniform(-20, 480, (64, 2))
    gt = np.concatenate([xy, xy + rng.uniform(1, 300, (64, 2))], 1).astype(
        np.float32)
    codes = rng.uniform(0, 5, (64, 4)).astype(np.float32)
    _close(j_boxes.linear_encode(jnp.asarray(anchors), jnp.asarray(gt)),
           t_boxes.linear_encode(torch.from_numpy(anchors),
                                 torch.from_numpy(gt)))
    _close(j_boxes.linear_decode(jnp.asarray(codes), jnp.asarray(anchors)),
           t_boxes.linear_decode(torch.from_numpy(codes),
                                 torch.from_numpy(anchors)))


# -- losses --------------------------------------------------------------------

def test_focal_dense_ce_masked_sum_match_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(4, 50, 9) * 4).astype(np.float32)
    labels = rng.randint(0, 9, (4, 50))
    fg = rng.rand(4, 50) > 0.6
    targets = (np.eye(9, dtype=np.float32)[labels] * fg[..., None])
    _close(j_losses.sigmoid_focal_loss(jnp.asarray(logits),
                                       jnp.asarray(targets)),
           t_losses.sigmoid_focal_loss(torch.from_numpy(logits),
                                       torch.from_numpy(targets)))
    # dense CE on sigmoid outputs, as the DG modes feed it (rows without a
    # foreground target give 0)
    probs = 1 / (1 + np.exp(-logits))
    _close(j_losses.softmax_cross_entropy_dense(jnp.asarray(probs),
                                                jnp.asarray(targets)),
           t_losses.softmax_cross_entropy_dense(torch.from_numpy(probs),
                                                torch.from_numpy(targets)))
    values = rng.randn(4, 50).astype(np.float32)
    _close(j_losses.masked_sum(jnp.asarray(values), jnp.asarray(fg)),
           t_losses.masked_sum(torch.from_numpy(values), torch.from_numpy(fg)),
           atol=1e-5)


def _giou_boxes(case):
    rng = np.random.RandomState(2)
    n = 40
    xy = rng.uniform(0, 100, (n, 2))
    pred = np.concatenate([xy, xy + rng.uniform(0, 60, (n, 2))], 1)
    xy = rng.uniform(0, 100, (n, 2))
    target = np.concatenate([xy, xy + rng.uniform(1, 60, (n, 2))], 1)
    if case == "disjoint":
        target[:, [0, 2]] += 400.0
    elif case == "degenerate":
        pred[:10, 2:] = pred[:10, :2]  # zero-size predictions
        pred[10:20, 2] = pred[10:20, 0]  # zero width
        target[20:30] = 0.0  # a padded all-zero target
        pred[25:30] = 0.0  # ... against a point at the origin: area_c = 0
        pred[30:35] = target[30:35]  # identical boxes
    return pred.astype(np.float32), target.astype(np.float32)


@pytest.mark.parametrize("case", ["ordinary", "disjoint", "degenerate"])
def test_giou_loss_matches_jax(case):
    pred, target = _giou_boxes(case)
    ref = j_losses.giou_loss(jnp.asarray(pred), jnp.asarray(target))
    got = t_losses.giou_loss(torch.from_numpy(pred), torch.from_numpy(target))
    _close(ref, got)
    assert torch.isfinite(got).all()


def test_giou_loss_gradient_is_finite_where_the_enclosing_box_is_empty():
    pred, target = _giou_boxes("degenerate")
    w = np.random.RandomState(3).rand(len(pred)).astype(np.float32)
    w[25:30] = 0.0  # masked out, as a padded location is in fcos_loss
    ref = np.asarray(jax.grad(lambda p: jnp.sum(
        j_losses.giou_loss(p, jnp.asarray(target)) * w))(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (t_losses.giou_loss(p, torch.from_numpy(target))
         * torch.from_numpy(w)).sum(), p)
    assert torch.isfinite(got).all()
    # the reference's single `where` back-propagates 0/0 from the branch it
    # does not take: NaN at the empty enclosing boxes, the same elsewhere
    assert np.isnan(ref[25:30]).all()
    ok = np.isfinite(ref).all(1)
    _close(ref[ok], got.numpy()[ok], rtol=1e-5, atol=1e-6)


# -- anchors -------------------------------------------------------------------

@pytest.mark.parametrize("canvas", [(128, 256), (608, 1216)])
def test_fcos_anchors_match_jax(canvas):
    ref, ref_counts = j_fcos.fcos_anchors_for(canvas)
    got, got_counts = t_fcos.fcos_anchors_for(canvas)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype == np.float32
    assert tuple(got_counts) == tuple(ref_counts)
    shapes = t_anchors.fpn_feat_shapes(canvas, t_fcos.STRIDES)
    assert shapes == j_anchors.fpn_feat_shapes(canvas, (8, 16, 32, 64, 128))
    if canvas == (608, 1216):
        assert tuple(got_counts) == (11552, 2888, 722, 190, 50)
        # the stride is ih // fh, iw // fw: (60, 64) on P6, (121, 121) on
        # P7, while the boxes keep the sides 64 and 128
        p6 = got[sum(got_counts[:3]):sum(got_counts[:4])]
        p7 = got[sum(got_counts[:4]):]
        np.testing.assert_array_equal(p6[1] - p6[0], [64, 0, 64, 0])
        np.testing.assert_array_equal(p6[19] - p6[0], [0, 60, 0, 60])
        np.testing.assert_array_equal(p7[1] - p7[0], [121, 0, 121, 0])
        np.testing.assert_array_equal(p7[0, 2:] - p7[0, :2], [128, 128])


# -- the FCOS matcher (K4's plain version) ---------------------------------------

@pytest.fixture(scope="module")
def hard_gt():
    anchors, counts = t_fcos.fcos_anchors_for(chip_smoke.CANVAS)
    gt, valid = chip_smoke.fcos_match_gt(np.random.RandomState(11), anchors,
                                         counts)
    return anchors, counts, gt, valid


@pytest.mark.parametrize("exact_area", [False, True])
def test_fcos_match_matches_jax_and_pallas(hard_gt, exact_area, monkeypatch):
    anchors, counts, gt, valid = hard_gt
    got = t_matchers.fcos_match_batched(
        torch.from_numpy(anchors), torch.from_numpy(gt),
        torch.from_numpy(valid), counts, 1.5, exact_area).numpy()
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid))
    ref = np.asarray(j_matchers.fcos_match_batched(
        *args, counts, 1.5, exact_area))
    monkeypatch.setattr(j_pallas_matchers, "TILE", 2048)  # 8 grid steps
    pallas = np.asarray(j_pallas_matchers.fcos_match_tpu(
        *args, tuple(counts), 1.5, exact_area, interpret=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert (got[0] == -1).all()  # no valid gt
    assert ((got >= -1) & (got < gt.shape[1])).all()
    assert all((got[b] >= 0).any() for b in range(1, len(got)))
    # the near-tie pairs and the boundary gt decide many locations
    assert (got[2] >= 0).sum() > 100 and (got[3] >= 0).sum() > 100


def test_fcos_match_plain_breaks_near_ties_by_rounded_area():
    """Two gt around the same anchors, areas 4 px^2 apart: 1e8 - area rounds
    both to the same float32 (ulp 8), so the first index wins, whichever is
    smaller; 16 px^2 apart, the smaller wins."""
    anchors = np.array([[96, 96, 104, 104]], np.float32)  # centre (100, 100)
    counts = (1,)
    for extra, want in ((4.0, (0, 0)), (16.0, (1, 0))):
        a = [60, 60, 140, 140]  # area 6400
        b = [60, 60, 140, 140 + extra / 80]  # area 6400 + extra
        gt = np.array([[b, a], [a, b]], np.float32)
        valid = np.ones((2, 2), bool)
        got = t_matchers.fcos_match(torch.from_numpy(anchors),
                                    torch.from_numpy(gt),
                                    torch.from_numpy(valid), counts)
        ref = j_matchers.fcos_match_batched(jnp.asarray(anchors),
                                            jnp.asarray(gt),
                                            jnp.asarray(valid), counts)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert tuple(got[:, 0].tolist()) == want


# -- first-k NMS (K6's plain version) --------------------------------------------

@pytest.mark.parametrize("iou", [0.5, 0.6])
@pytest.mark.parametrize("class_aware", [False, True])
def test_nms_topk_plain_matches_jax(class_aware, iou):
    """Rows with quantised scores (ties), invalid entries, fewer than k
    survivors (row 1) and none valid (row 2)."""
    boxes, scores, labels, valid = chip_smoke.nms_candidates(
        np.random.RandomState(13), 400)
    k = 100
    t_args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
    if class_aware:
        got = t_nms.batched_nms_topk(t_args[0], t_args[1],
                                     torch.from_numpy(labels), t_args[2], iou,
                                     k)
        plain = t_nms.nms_topk_plain(
            t_nms._class_offsets(t_args[0], torch.from_numpy(labels)),
            *t_args[1:], iou, k)
    else:
        got = t_nms.nms_topk(*t_args, iou, k)
        plain = t_nms.nms_topk_plain(*t_args, iou, k)
    for a, b in zip(got, plain):  # the CPU dispatcher is the plain version
        assert torch.equal(a, b)
    for b in range(len(boxes)):
        if class_aware:
            ref = j_nms.batched_nms_topk(
                jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                jnp.asarray(labels[b]), jnp.asarray(valid[b]), iou, k)
        else:
            ref = j_nms.nms_topk(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                 jnp.asarray(valid[b]), iou, k)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(got[2][b].numpy(), np.asarray(ref[2]),
                                   rtol=1e-6)
    ok = got[1].numpy()
    assert ok[0].all() and ok[1].sum() <= 30 and not ok[2].any()
    assert (got[0].numpy()[~ok] == 0).all()  # idx 0 where nothing was picked
    assert np.isneginf(got[2].numpy()[~ok]).all()


# -- kernel wrappers: CPU tensors are refused ---------------------------------

def test_fcos_and_nms_wrappers_refuse_cpu_tensors():
    anchors = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        cuda_matchers.fcos_match_cuda(anchors, torch.zeros(1, 4, 4),
                                      torch.zeros(1, 4, dtype=torch.bool),
                                      (8,))
    with pytest.raises(ValueError):
        cuda_nms.nms_topk_cuda(torch.zeros(1, 5, 4), torch.zeros(1, 5),
                               torch.zeros(1, 5, dtype=torch.bool), 0.5, 3)
    assert cuda_matchers.fcos_launches == 0
    assert cuda_nms.launches == 0
