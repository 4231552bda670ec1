"""Port parity: box ops, losses, anchors, matchers, sampler, NMS, optimizer.

Same numpy inputs through dgod_tpu (JAX, CPU; the conftest pins the XLA
paths) and dgod_tpu_torch (torch, CPU). Elementwise float results agree to
rtol 1e-6 (same float32 ops in the same order); discrete results (match
codes, sampled indices, keep masks) are exactly equal. The RPN matcher is
also held against the Pallas kernel in interpret mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dgod_tpu.ops import anchors as j_anchors
from dgod_tpu.ops import boxes as j_boxes
from dgod_tpu.ops import losses as j_losses
from dgod_tpu.ops import matchers as j_matchers
from dgod_tpu.ops import nms as j_nms
from dgod_tpu.ops import pallas_matchers as j_pallas_matchers
from dgod_tpu.train import optim as j_optim
from dgod_tpu.train import steps as j_steps
from dgod_tpu_torch.ops import anchors as t_anchors
from dgod_tpu_torch.ops import boxes as t_boxes
from dgod_tpu_torch.ops import cuda_matchers, cuda_proposals, cuda_roi_align
from dgod_tpu_torch.ops import losses as t_losses
from dgod_tpu_torch.ops import matchers as t_matchers
from dgod_tpu_torch.ops import nms as t_nms
from dgod_tpu_torch.train import optim as t_optim
from dgod_tpu_torch.train import steps as t_steps


def _boxes(rng, n, span=200.0, min_wh=1.0, max_wh=80.0):
    xy = rng.uniform(-10, span, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=rtol, atol=atol)


# -- boxes -------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["box_iou", "elementwise_iou", "box_area"])
def test_box_geometry_matches_jax(fn):
    rng = np.random.RandomState(0)
    a = _boxes(rng, 40)
    b = _boxes(rng, 40)
    a[3] = a[4] = 0.0  # degenerate boxes: zero union
    b[4] = 0.0
    args = (a,) if fn == "box_area" else (a, b)
    ref = getattr(j_boxes, fn)(*map(jnp.asarray, args))
    got = getattr(t_boxes, fn)(*map(torch.from_numpy, args))
    _close(ref, got)


def test_clip_and_small_box_mask_match_jax():
    rng = np.random.RandomState(1)
    b = _boxes(rng, 64, span=300, min_wh=0.0, max_wh=2.0)
    h = np.float32([[100.0], [150.0]]).repeat(32, 0).reshape(64)
    w = np.float32(240.0)
    _close(j_boxes.clip_boxes(jnp.asarray(b), jnp.asarray(h), w),
           t_boxes.clip_boxes(torch.from_numpy(b), torch.from_numpy(h), w))
    for m in (1e-3, 1e-2, 1.0):
        np.testing.assert_array_equal(
            np.asarray(j_boxes.small_box_mask(jnp.asarray(b), m)),
            t_boxes.small_box_mask(torch.from_numpy(b), m).numpy())


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_delta_coder_matches_jax(weights):
    rng = np.random.RandomState(2)
    gt = _boxes(rng, 50)
    prop = _boxes(rng, 50)
    prop[0] = [5, 5, 5, 9]  # degenerate proposal: safe width
    gt[1] = [7, 7, 7, 7]  # degenerate gt
    _close(j_boxes.delta_encode(jnp.asarray(gt), jnp.asarray(prop), weights),
           t_boxes.delta_encode(torch.from_numpy(gt), torch.from_numpy(prop),
                                weights), rtol=1e-6, atol=1e-5)
    codes = rng.randn(50, 4).astype(np.float32)
    codes[:5, 2:] = 30.0  # dw/dh beyond the log(1000/16) clamp
    _close(j_boxes.delta_decode(jnp.asarray(codes), jnp.asarray(prop), weights),
           t_boxes.delta_decode(torch.from_numpy(codes), torch.from_numpy(prop),
                                weights), rtol=1e-6, atol=1e-4)


# -- losses ------------------------------------------------------------------

@pytest.mark.parametrize("beta", [1.0, 1 / 9])
def test_smooth_l1_matches_jax(beta):
    rng = np.random.RandomState(3)
    p, t = rng.randn(2, 200).astype(np.float32) * 0.5
    _close(j_losses.smooth_l1(jnp.asarray(p), jnp.asarray(t), beta),
           t_losses.smooth_l1(torch.from_numpy(p), torch.from_numpy(t), beta))


def test_bce_ce_masked_mean_match_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(300) * 8).astype(np.float32)
    y = (rng.rand(300) > 0.5).astype(np.float32)
    _close(j_losses.bce_with_logits(jnp.asarray(x), jnp.asarray(y)),
           t_losses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y)))
    logits = rng.randn(4, 7, 10).astype(np.float32)
    labels = rng.randint(0, 10, (4, 7)).astype(np.int32)
    _close(j_losses.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)),
           t_losses.softmax_cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels)))
    mask = rng.rand(4, 7) > 0.5
    for m in (mask, np.zeros_like(mask)):
        _close(j_losses.masked_mean(jnp.asarray(logits[..., 0]),
                                    jnp.asarray(m)),
               t_losses.masked_mean(torch.from_numpy(logits[..., 0]),
                                    torch.from_numpy(m)))


# -- anchors -----------------------------------------------------------------

@pytest.mark.parametrize("canvas", [(608, 1216), (128, 256)])
def test_rpn_anchors_match_jax(canvas):
    strides = (4, 8, 16, 32, 64)
    shapes = t_anchors.fpn_feat_shapes(canvas, strides)
    assert shapes == j_anchors.fpn_feat_shapes(canvas, strides)
    a_t, c_t = t_anchors.rpn_anchors(shapes, canvas)
    a_j, c_j = j_anchors.rpn_anchors(shapes, canvas)
    np.testing.assert_array_equal(a_t, a_j)
    assert c_t == c_j
    if canvas == (608, 1216):
        assert a_t.shape == (184680, 4)


# -- matchers ----------------------------------------------------------------

def _gt_batch(rng, B, G, anchors=None):
    """Padded GT: image 0 empty; exact anchor copies and a duplicate gt
    (ties in the argmax and the rescue); junk in the padding."""
    boxes = rng.uniform(0, 50, (B, G, 4)).astype(np.float32)  # junk padding
    valid = np.zeros((B, G), bool)
    for b in range(1, B):
        n = rng.randint(3, G + 1)
        boxes[b, :n] = _boxes(rng, n, span=300, min_wh=5, max_wh=120)
        valid[b, :n] = True
        if anchors is not None:
            boxes[b, 0] = anchors[rng.randint(len(anchors))]
        boxes[b, 2] = boxes[b, 1]
    return boxes, valid


@pytest.mark.parametrize("allow", [True, False])
def test_iou_match_codes_match_jax(allow):
    rng = np.random.RandomState(5)
    G, R = 12, 300
    # coarse values: many exact ties in the max, the argmax and the rescue
    iou = (rng.randint(0, 11, (3, G, R)) / 10.0).astype(np.float32)
    valid = rng.rand(3, G) > 0.3
    valid[0] = False  # empty GT -> all BELOW_LOW
    for thr in ((0.7, 0.3), (0.5, 0.5)):
        got = t_matchers.iou_match(torch.from_numpy(iou),
                                   torch.from_numpy(valid), *thr, allow)
        for b in range(3):
            ref = j_matchers.iou_match(jnp.asarray(iou[b]),
                                       jnp.asarray(valid[b]), *thr, allow)
            np.testing.assert_array_equal(np.asarray(ref), got[b].numpy())
    assert (got[0] == t_matchers.BELOW_LOW).all()


def test_match_anchors_batched_matches_jax_and_pallas(monkeypatch):
    monkeypatch.setattr(j_pallas_matchers, "TILE", 256)
    rng = np.random.RandomState(6)
    anchors = _boxes(rng, 700, span=380, min_wh=8, max_wh=96)
    gt, valid = _gt_batch(rng, 4, 16, anchors)
    args = (0.7, 0.3, True)
    got = t_matchers.match_anchors_batched(
        torch.from_numpy(gt), torch.from_numpy(valid),
        torch.from_numpy(anchors), *args).numpy()
    ref = np.asarray(j_matchers.match_anchors_batched(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(anchors), *args))
    pallas = np.asarray(j_pallas_matchers.iou_match_tpu(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(anchors), *args,
        interpret=True))
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(pallas, got)
    assert got.dtype == np.int32
    assert (got[0] == t_matchers.BELOW_LOW).all()
    assert (got >= 0).any() and (got == t_matchers.BETWEEN).any()


# -- K3's pruned matcher (csrc/iou_match.cu), modelled on the CPU --------------

def _k3_iou(g, a):
    """The kernel's IoU of aligned boxes: a pair that does not intersect is
    exactly 0 without the division."""
    iw = torch.minimum(g[..., 2], a[..., 2]) - torch.maximum(g[..., 0], a[..., 0])
    ih = torch.minimum(g[..., 3], a[..., 3]) - torch.maximum(g[..., 1], a[..., 1])
    hit = (iw > 0) & (ih > 0)
    out = torch.zeros_like(iw)
    inter = iw[hit] * ih[hit]
    ga = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    aa = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    uni = ga.expand_as(iw)[hit] + aa.expand_as(iw)[hit] - inter
    out[hit] = torch.where(uni > 0, inter / uni, torch.zeros_like(inter))
    return out


K3_CHUNK, K3_WARP, K3_BLOCK = 1024, 128, 1024  # anchors per pass-1 block
# and warp, per pass-2 block


def _k3_box(a):
    """The box around anchors a [n,4]."""
    return torch.cat([a[:, :2].min(0).values, a[:, 2:].max(0).values])


def _k3_meets(g, box):
    """Which of the boxes g [n,4] intersect `box` [4], as the kernel tests."""
    return ((torch.minimum(g[:, 2], box[2]) - torch.maximum(g[:, 0], box[0])
             > 0) & (torch.minimum(g[:, 3], box[3])
                     - torch.maximum(g[:, 1], box[1]) > 0))


def _k3_model(gt, valid, anchors, high, low, allow):
    """The kernel's steps, per image. Pass 1, per chunk of 1024 anchors:
    the valid gt that meet the chunk's box, in index order; per warp of 128
    anchors, those that meet its box: each anchor's max IoU (from 0) and
    the first index that exceeds it (-1 until then: the first valid gt),
    each gt's best (from 0). Pass 2: the 0.7/0.3 codes; the rescue, every
    anchor where a valid gt has best 0, else per block of 1024 anchors
    tested against the valid gt whose best is at most the block's largest
    max and that meet its box. -> (codes [B,R], IoUs of pass 1, IoUs of
    pass 2)."""
    B, R = gt.shape[0], anchors.shape[0]
    out = torch.full((B, R), t_matchers.BELOW_LOW, dtype=torch.int32)
    n1 = n2 = 0
    for b in range(B):
        idx = torch.nonzero(valid[b]).flatten()
        if not len(idx):
            continue
        g = gt[b, idx]
        mv = torch.zeros(R)
        arg = torch.full((R,), -1)
        best = torch.zeros(len(idx))
        for c0 in range(0, R, K3_CHUNK):
            listed = torch.nonzero(_k3_meets(
                g, _k3_box(anchors[c0:c0 + K3_CHUNK]))).flatten()
            for w0 in range(c0, min(c0 + K3_CHUNK, R), K3_WARP):
                a = anchors[w0:w0 + K3_WARP]
                sl = slice(w0, w0 + len(a))
                for j in listed[_k3_meets(g[listed], _k3_box(a))]:
                    v = _k3_iou(g[j][None], a)
                    n1 += len(a)
                    up = v > mv[sl]  # strict: the first index wins
                    mv[sl] = torch.where(up, v, mv[sl])
                    arg[sl] = torch.where(up, idx[j], arg[sl])
                    best[j] = torch.maximum(best[j], v.max())
        match = torch.where(arg < 0, idx[0], arg).to(torch.int32)
        code = torch.where(mv < low, t_matchers.BELOW_LOW,
                           torch.where(mv < high, t_matchers.BETWEEN, match))
        if allow:
            rescued = torch.full((R,), bool((best == 0).any()))
            for r0 in range(0, R, K3_BLOCK):
                if rescued[0]:
                    break
                a, m = anchors[r0:r0 + K3_BLOCK], mv[r0:r0 + K3_BLOCK]
                sl = slice(r0, r0 + len(a))
                can = (best <= m.max()) & _k3_meets(g, _k3_box(a))
                for j in torch.nonzero(can).flatten():
                    v = _k3_iou(g[j][None], a)
                    n2 += int((best[j] <= m).sum())  # a thread's tests
                    rescued[sl] |= (best[j] <= m) & (v == best[j])
            code = torch.where(rescued, match, code)
        out[b] = code.to(torch.int32)
    return out, n1, n2


def _k3_batch(rng, anchors):
    """G = 128 padded gt over 5 images: no valid gt; all 128 valid; gt equal
    to anchors with duplicates; few valid with junk in the padding; one
    valid gt wholly off the canvas (best 0) among ordinary ones."""
    G = 128
    gt = rng.uniform(-50, 300, (5, G, 4)).astype(np.float32)  # junk
    valid = np.zeros((5, G), bool)
    gt[1] = _boxes(rng, G, span=180, min_wh=2, max_wh=60)
    valid[1] = True
    gt[2, :12] = anchors[rng.randint(len(anchors), size=12)]
    gt[2, 12:24] = gt[2, :12]
    valid[2, :24] = True
    gt[3, :5] = _boxes(rng, 5, span=180, min_wh=8, max_wh=60)
    valid[3, :5] = True
    gt[4, :6] = _boxes(rng, 6, span=180, min_wh=8, max_wh=60)
    gt[4, 3] = [900, 900, 960, 950]  # overlaps no anchor
    valid[4, :6] = True
    return gt, valid


@pytest.mark.parametrize("allow", [True, False])
def test_k3_pruned_matcher_model_matches_plain_and_jax(allow, monkeypatch):
    monkeypatch.setattr(j_pallas_matchers, "TILE", 256)
    rng = np.random.RandomState(12)
    canvas = (96, 192)  # the RPN's anchors, in the kernel's order
    anchors = t_anchors.rpn_anchors(
        t_anchors.fpn_feat_shapes(canvas, (4, 8, 16, 32, 64)), canvas)[0]
    anchors = np.asarray(anchors, np.float32)
    gt, valid = _k3_batch(rng, anchors)
    args = (0.7, 0.3, allow)
    t_in = [torch.from_numpy(x) for x in (gt, valid, anchors)]
    got, n1, n2 = _k3_model(*t_in, *args)
    plain = t_matchers.match_anchors_plain(*t_in, *args)
    xla = np.asarray(j_matchers.match_anchors_batched(
        *map(jnp.asarray, (gt, valid, anchors)), *args))
    pallas = np.asarray(j_pallas_matchers.iou_match_tpu(
        *map(jnp.asarray, (gt, valid, anchors)), *args, interpret=True))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    np.testing.assert_array_equal(xla, got.numpy())
    np.testing.assert_array_equal(pallas, got.numpy())
    assert (got[0] == t_matchers.BELOW_LOW).all()
    assert (got[1] >= 0).any() and (got[2] >= 0).any()
    mv = _k3_iou(torch.from_numpy(gt[4, :6])[:, None],
                 torch.from_numpy(anchors)[None]).max(0).values
    assert (mv == 0).any()
    if allow:
        # the off-canvas gt (best 0) ties with every anchor: all of image
        # 4's anchors keep their argmax, the first valid gt where none
        # overlaps
        assert (got[4] >= 0).all() and (got[4][mv == 0] == 0).all()
    else:
        assert (got[4][mv == 0] == t_matchers.BELOW_LOW).all()
    # the culled passes compute a small part of the pairs' IoUs
    pairs = int(valid.sum()) * len(anchors)
    assert 0 < n1 < pairs / 2 and n2 < pairs / 5


@pytest.mark.parametrize("case", ["many_pos", "few_pos", "pad", "ties"])
def test_balanced_sample_matches_jax(case, monkeypatch):
    rng = np.random.RandomState(7)
    R, num, frac = {"many_pos": (400, 64, 0.25), "few_pos": (400, 64, 0.5),
                    "pad": (40, 64, 0.5), "ties": (300, 32, 0.5)}[case]
    pos = rng.rand(2, R) < (0.5 if case == "many_pos" else 0.02)
    neg = ~pos & (rng.rand(2, R) < 0.7)
    key = jax.random.PRNGKey(11)
    got_all = []
    pos_u, neg_u = [], []
    for b, kb in enumerate(jax.random.split(key, 2)):
        k_pos, k_neg = jax.random.split(kb)
        pu = np.asarray(jax.random.uniform(k_pos, (R,)))
        nu = np.asarray(jax.random.uniform(k_neg, (R,)))
        if case == "ties":  # equal priorities: top-k order decides
            pu = np.floor(pu * 4) / 4
            nu = np.floor(nu * 4) / 4
        pos_u.append(pu)
        neg_u.append(nu)
        # the JAX sampler with these priorities in place of its own draws
        ref = _jax_sample_with(monkeypatch, jnp.asarray(pos[b]),
                               jnp.asarray(neg[b]), num, frac,
                               jnp.asarray(pu), jnp.asarray(nu))
        if case != "ties":
            direct = j_matchers.balanced_sample(
                jnp.asarray(pos[b]), jnp.asarray(neg[b]), num, frac, kb)
            for x, y in zip(direct, ref):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        got_all.append(ref)
    got = t_matchers.balanced_sample(
        torch.from_numpy(pos), torch.from_numpy(neg), num, frac,
        torch.from_numpy(np.stack(pos_u)), torch.from_numpy(np.stack(neg_u)))
    for b in range(2):
        ref = got_all[b]
        np.testing.assert_array_equal(np.asarray(ref.idx), got.idx[b].numpy())
        np.testing.assert_array_equal(np.asarray(ref.is_pos),
                                      got.is_pos[b].numpy())
        np.testing.assert_array_equal(np.asarray(ref.valid),
                                      got.valid[b].numpy())


def _jax_sample_with(monkeypatch, pos_mask, neg_mask, num_samples, frac,
                     pos_u, neg_u):
    """dgod_tpu's balanced_sample with its two uniform draws replaced by
    the given priorities."""
    draws = iter([pos_u, neg_u])
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", lambda *a, **k: next(draws))
        return j_matchers.balanced_sample(pos_mask, neg_mask, num_samples,
                                          frac, jax.random.PRNGKey(0))


# -- NMS ---------------------------------------------------------------------

def _clustered(rng, B, K):
    centers = rng.uniform(20, 200, (B, 6, 2))
    pick = rng.randint(0, 6, (B, K))
    ctr = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(B, K, 2) * 6
    wh = rng.uniform(10, 40, (B, K, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = rng.rand(B, K).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # a score tie
    valid = rng.rand(B, K) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("block", [16, 256])
def test_nms_mask_blocked_matches_jax(block):
    rng = np.random.RandomState(8)
    boxes, scores, valid = _clustered(rng, 3, 70)
    got = t_nms.nms_mask_blocked(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(valid), 0.5, block)
    for b in range(3):
        ref = j_nms.nms_mask_blocked(jnp.asarray(boxes[b]),
                                     jnp.asarray(scores[b]),
                                     jnp.asarray(valid[b]), 0.5, block)
        np.testing.assert_array_equal(np.asarray(ref), got[b].numpy())


@pytest.mark.parametrize("class_aware", [False, True])
def test_nms_topk_matches_jax(class_aware):
    rng = np.random.RandomState(9)
    boxes, scores, valid = _clustered(rng, 3, 60)
    labels = rng.randint(1, 4, (3, 60))
    k = 25
    if class_aware:
        got = t_nms.batched_nms_topk(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(labels), torch.from_numpy(valid), 0.5, k)
    else:
        got = t_nms.nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(valid), 0.5, k)
    for b in range(3):
        if class_aware:
            ref = j_nms.batched_nms_topk(
                jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                jnp.asarray(labels[b]), jnp.asarray(valid[b]), 0.5, k)
        else:
            ref = j_nms.nms_topk(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                 jnp.asarray(valid[b]), 0.5, k)
        np.testing.assert_array_equal(np.asarray(ref[1]), got[1][b].numpy())
        ok = np.asarray(ref[1])
        np.testing.assert_array_equal(np.asarray(ref[0])[ok],
                                      got[0][b].numpy()[ok])
        _close(np.asarray(ref[2])[ok], got[2][b].numpy()[ok])


# -- optimizer and schedule ----------------------------------------------------

@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_masked_update_matches_jax(kind):
    rng = np.random.RandomState(10)
    names = ("a", "b", "c", "d")
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2), "d": (4,)}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    active = {"a": True, "b": True, "c": False, "d": True}
    cfg = (t_optim.OptConfig(kind, weight_decay=5e-4), j_optim.OptConfig(
        kind, weight_decay=5e-4))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    j_state = j_optim.init_opt_state(jp, cfg[1])
    t_state = t_optim.init_opt_state(tp, cfg[0])
    for step in range(3):
        grads = {n: rng.randn(*shapes[n]).astype(np.float32) for n in names}
        # 'd' is active but unreached by the loss: zero grad, still decays
        grads["d"] = np.zeros(shapes["d"], np.float32)
        jp, j_state = j_optim.apply_updates(
            jp, {n: jnp.asarray(g) for n, g in grads.items()}, j_state,
            active, 1e-2, cfg[1])
        t_grads = {n: torch.from_numpy(g) for n, g in grads.items()}
        t_grads["d"] = None
        t_state = t_optim.apply_updates(tp, t_grads, t_state, active, 1e-2,
                                        cfg[0])
    for n in names:
        _close(jp[n], tp[n], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(tp["c"].numpy(), params["c"])
    assert not np.array_equal(tp["d"].numpy(), params["d"])
    if kind == "adam":
        assert t_state["count"] == {"a": 3, "b": 3, "c": 0, "d": 3}


def test_schedule_and_groups_match_jax():
    assert t_steps.MODE_ACTIVE_GROUPS == j_steps.MODE_ACTIVE_GROUPS
    a, b = t_steps.ModeScheduler(True), j_steps.ModeScheduler(True)
    assert [a.next_mode() for _ in range(11)] == [b.next_mode()
                                                  for _ in range(11)]
    assert t_steps.ModeScheduler(False).next_mode() == 0
    for name in ("FRCNN", "FCOS"):
        assert tuple(t_steps.make_optimizer(name)[0]) == tuple(
            j_steps.make_optimizer(name)[0])
        assert t_steps.make_optimizer(name)[1] == j_steps.make_optimizer(name)[1]


# -- kernel wrappers: CPU tensors are refused ---------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    gt = torch.zeros(1, 4, 4)
    with pytest.raises(ValueError):
        cuda_matchers.iou_match_cuda(gt, torch.zeros(1, 4, dtype=torch.bool),
                                     torch.zeros(8, 4), 0.7, 0.3, True)
    feats = [torch.zeros(1, h, 2 * h, 8) for h in (8, 4, 2, 1)]
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_fwd_cuda(feats, torch.zeros(1, 3, 4))
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_cuda(feats, torch.zeros(1, 3, 4))
    with pytest.raises(ValueError):
        cuda_roi_align.roi_align_bwd_cuda(feats, torch.zeros(1, 3, 4),
                                          torch.zeros(1, 3, 7, 7, 8))
    with pytest.raises(ValueError):
        cuda_proposals.decode_nms_cuda(torch.zeros(1, 8, 4),
                                       torch.zeros(1, 8, 4),
                                       torch.ones(1, 2), (8,), 0.7)
    assert cuda_matchers.launches == 0
    assert cuda_proposals.launches == 0
    assert cuda_roi_align.fwd_launches == 0
    assert cuda_roi_align.bwd_launches == 0
