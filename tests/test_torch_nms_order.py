"""Kernel K6's order of work (dgod_tpu_torch/csrc/nms_topk.cu), modelled in
numpy, equals the greedy argmax rounds of first-k NMS.

The kernel does not run k argmax-and-suppress rounds. It gives each live
entry a unique rank key (score descending, the lower index first among
equal scores, -0.0 counted as +0.0), takes the entries a tile at a time in
rank order (the best TILE of what is left, sorted), drops a candidate that
a box kept so far suppresses, and decides the rest ROWS at a time with an
upper-triangular IoU bitmask and a serial scan, stopping at k kept. After a
tile that kept at most FILTER_MAX boxes, the entries left behind are first
filtered against those boxes. `rank_order_scan` below is that procedure,
step for step, in float32 IEEE arithmetic in the kernel's order; the CUDA
kernel runs only on the card (`chip_smoke.py` holds it to the plain
version there).

The model is held exactly (idx and ok) against the port's plain version
`nms_topk_plain` (the argmax rounds) and against dgod_tpu's `nms_topk` /
`batched_nms_topk` (JAX, CPU), on seeded rows with quantised-score ties,
-0.0 and +0.0 scores, no live entry, fewer than k survivors, exact
duplicates, and tiles whose survivors suppress each other in a chain. The
tile is cut to 64 entries and the step to 16 rows here, so that a row of a
few hundred entries crosses several tiles and steps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgod_tpu.ops import nms as j_nms
from dgod_tpu_torch.ops import nms as t_nms

# the kernel's sizes (csrc/nms_topk.cu: THREADS, ROWS, FILTER_MAX)
TILE, ROWS, FILTER_MAX = 1024, 64, 16


def rank_keys(scores: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Unique uint64 keys, ascending in the greedy order: the float32 score
    (plus 0.0, so -0.0 counts as +0.0) mapped to an order-preserving
    uint32, complemented (descending), above the index."""
    s = (scores.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    u = np.where(s & np.uint32(0x80000000), ~s, s | np.uint32(0x80000000))
    return ((~u).astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint64)


def _area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def over(kept: np.ndarray, cand: np.ndarray, thr) -> np.ndarray:
    """kept [m,4], cand [n,4] -> [m,n] bool: IoU above thr, the plain
    version's float32 operations (kept box first)."""
    p, q = kept[:, None, :], cand[None, :, :]
    iw = np.maximum(np.minimum(p[..., 2], q[..., 2])
                    - np.maximum(p[..., 0], q[..., 0]), np.float32(0))
    ih = np.maximum(np.minimum(p[..., 3], q[..., 3])
                    - np.maximum(p[..., 1], q[..., 1]), np.float32(0))
    inter = iw * ih
    union = (_area(p) + _area(q)) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, np.float32(0))
    return iou > np.float32(thr)


def suppressed(kept: np.ndarray, cand: np.ndarray, thr) -> np.ndarray:
    """cand [n,4] -> [n] bool: suppressed by some box of kept [m,4]."""
    if not len(kept) or not len(cand):
        return np.zeros(len(cand), bool)
    return over(kept, cand, thr).any(0)


def rank_order_scan(boxes, scores, valid, thr, k, tile=TILE, rows=ROWS,
                    filter_max=FILTER_MAX):
    """One row: boxes [K,4] f32, scores [K] f32, valid [K] bool -> (idx [k]
    int64, ok [k] bool) by the kernel's procedure."""
    boxes = boxes.astype(np.float32)
    live = np.nonzero(valid & (scores > -np.inf))[0]
    pool = rank_keys(scores[live], live)  # compacted in index order
    kept, filt = [], 0
    while len(kept) < k and pool.size:
        new = np.array(kept[filt:], np.int64)
        if 0 < len(new) <= filter_max:  # filter what is left behind
            at = (pool & np.uint64(0xFFFFFFFF)).astype(np.int64)
            pool = pool[~suppressed(boxes[new], boxes[at], thr)]
            filt = len(kept)
            continue
        order = np.sort(pool)  # the kernel selects the best `tile`, sorts
        cand = (order[:tile] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        pool = order[tile:]
        # the candidates' test against the kept boxes the pool never met
        cand = cand[~suppressed(boxes[kept[filt:]], boxes[cand], thr)]
        while cand.size and len(kept) < k:
            head = cand[:rows]
            n = len(head)
            # the step's bitmask: row i suppresses a later j
            diag = np.triu(over(boxes[head], boxes[head], thr), 1)
            removed = np.zeros(n, bool)
            first = len(kept)
            for j in range(n):
                if removed[j]:
                    continue
                if len(kept) == k:
                    break
                kept.append(int(head[j]))
                removed |= diag[j]
            rest = cand[rows:]
            cand = rest[~suppressed(boxes[kept[first:]], boxes[rest], thr)]
    idx = np.zeros(k, np.int64)
    ok = np.zeros(k, bool)
    idx[:len(kept)] = kept
    ok[:len(kept)] = True
    return idx, ok


# -- seeded rows --------------------------------------------------------------

B, K, KEEP = 3, 320, 100
SMALL = dict(tile=64, rows=16, filter_max=4)  # many tiles, steps and filters


def _row_case(case: str, rng: np.random.RandomState):
    """B rows of K candidates of one kind -> boxes, scores, valid, labels."""
    ctr = rng.uniform(0, 600, (B, 12, 2))[:, rng.randint(0, 12, K)]
    ctr = ctr + rng.randn(B, K, 2) * 6
    wh = np.exp(rng.uniform(np.log(8), np.log(200), (B, K, 2)))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = (np.floor(rng.rand(B, K) * 16) / 16).astype(np.float32)
    valid = rng.rand(B, K) > 0.1
    labels = rng.randint(1, 4, (B, K))
    if case == "zeros":  # +0.0 and -0.0, all tied: the lower index first
        scores = np.where(rng.rand(B, K) < 0.5, -0.0, 0.0).astype(np.float32)
    elif case == "invalid":  # nothing live, or only -inf scores
        valid[0] = False
        scores[1] = -np.inf
        valid[2, ::3] = False
    elif case == "few":  # fewer than k survivors
        valid[:] = False
        valid[:, rng.choice(K, 40, replace=False)] = True
    elif case == "duplicates":  # exact copies, equal scores included
        boxes[:, 1::2] = boxes[:, 0::2]
        scores[:, 1::4] = scores[:, 0::4]
    elif case == "chains":  # IoU 7/13 with the next, 1/4 with the one after:
        # each pick suppresses the next, so every other box is picked
        x = np.arange(K, dtype=np.float64) * 3.0
        boxes = np.tile(np.stack([x, 0 * x, x + 10, 0 * x + 10], 1), (B, 1, 1))
        scores = np.tile(np.linspace(1, 0.01, K, dtype=np.float32), (B, 1))
        scores[1] = scores[1, ::-1]
        valid[:] = True
    return boxes.astype(np.float32), scores, valid, labels


@pytest.mark.parametrize("case", ["ties", "zeros", "invalid", "few",
                                  "duplicates", "chains"])
def test_rank_order_scan_equals_the_argmax_rounds(case):
    """The kernel's order of work against the port's plain version and
    dgod_tpu's nms_topk, row by row: idx and ok exactly equal."""
    torch.set_num_threads(1)
    boxes, scores, valid, _ = _row_case(
        case, np.random.RandomState(["ties", "zeros", "invalid", "few",
                                     "duplicates", "chains"].index(case)))
    thr = 0.5
    plain = t_nms.nms_topk_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(valid), thr, KEEP)
    for b in range(B):
        for sizes in (SMALL, {}):  # the kernel's sizes: one tile
            idx, ok = rank_order_scan(boxes[b], scores[b], valid[b], thr,
                                      KEEP, **sizes)
            np.testing.assert_array_equal(idx, plain[0][b].numpy())
            np.testing.assert_array_equal(ok, plain[1][b].numpy())
        ref = j_nms.nms_topk(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                             jnp.asarray(valid[b]), thr, KEEP)
        np.testing.assert_array_equal(idx, np.asarray(ref[0]))
        np.testing.assert_array_equal(ok, np.asarray(ref[1]))
    if case == "chains":  # a chain keeps every other box, in score order
        assert plain[1][0].sum() == KEEP
        np.testing.assert_array_equal(plain[0][0].numpy(),
                                      np.arange(0, 2 * KEEP, 2))


def test_rank_order_scan_class_aware_matches_jax():
    """With the class offsets of batched_nms_topk (coordinates ~1e3)."""
    torch.set_num_threads(1)
    boxes, scores, valid, labels = _row_case("ties",
                                             np.random.RandomState(7))
    off = t_nms._class_offsets(torch.from_numpy(boxes),
                               torch.from_numpy(labels)).numpy()
    for b in range(B):
        idx, ok = rank_order_scan(off[b], scores[b], valid[b], 0.6, KEEP,
                                  **SMALL)
        ref = j_nms.batched_nms_topk(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
            jnp.asarray(labels[b]), jnp.asarray(valid[b]), 0.6, KEEP)
        np.testing.assert_array_equal(idx, np.asarray(ref[0]))
        np.testing.assert_array_equal(ok, np.asarray(ref[1]))


def test_rank_keys_order_as_argmax():
    """Descending score, the lower index first among equal scores, -0.0
    equal to +0.0, -inf last among the finite."""
    scores = np.float32([0.5, -0.0, 0.0, 0.5, np.inf, -1.0, 1e-30, -0.0])
    order = np.argsort(rank_keys(scores, np.arange(len(scores))))
    np.testing.assert_array_equal(order, [4, 0, 3, 6, 1, 2, 7, 5])


def test_threshold_test_without_division():
    """The kernel decides IoU > thr as inter > m * union in double, m the
    midpoint of thr and the next float up (a tie when that float is even):
    the same answer as the f32 division, on random pairs and on pairs whose
    quotient lies within a few ulps of thr."""
    rng = np.random.RandomState(3)
    for thr in np.float32([0.5, 0.6, 0.7, 1.0 / 3.0]):
        up = np.nextafter(thr, np.float32(np.inf))
        mid = (np.float64(thr) + np.float64(up)) / 2
        up_even = (up.view(np.uint32) & 1) == 0
        uni = np.exp(rng.uniform(0, np.log(1e8), 200_000)).astype(np.float32)
        near = (uni * thr).astype(np.float32)
        steps = rng.randint(-3, 4, uni.size).astype(np.float32)
        inter = np.concatenate([
            (uni * rng.rand(uni.size)).astype(np.float32),
            near + steps * np.spacing(near)])
        uni = np.concatenate([uni, uni])
        want = (inter / uni).astype(np.float32) > thr
        lhs, rhs = inter.astype(np.float64), mid * uni.astype(np.float64)
        got = (lhs > rhs) | ((lhs == rhs) & up_even)
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("K", [9000, 20974, 20975, 57000])
def test_nms_topk_cuda_names_its_capacity(K):
    """K6 keeps an image's live keys in shared memory (8 bytes each): the
    wrapper refuses, before the launch, more entries per image than the
    kernel holds, and names the limit. 20,974 is the H100's limit at
    k = 100 (227 KB a block, less the kernel's tile buffers, histogram and
    kept boxes); the FRCNN predict's 9,000 fits."""
    from dgod_tpu_torch.ops import cuda_nms

    if K <= 20974:
        cuda_nms.check_capacity(K, 100, 20974)
    else:
        with pytest.raises(ValueError, match=r"limit of 20974 at k=100"):
            cuda_nms.check_capacity(K, 100, 20974)
