"""The numbers that decide `correct`, each compared by common.verdict with
the cell's limit from perfbench/limits/<cell>.json. The readings and
controls that each limit was set from are in PERF.md."""

from __future__ import annotations

import statistics

import numpy as np

# a leaf whose largest gradient in the reference is under this share of the
# median leaf's is nought to rounding (a bias under a normalisation): Adam
# moves it by round-off alone, so its change is no reading of the program
NOUGHT = 1e-3


def _leaf_gap(prog: dict, ref: dict, leaves, pick=max) -> float:
    """The worst leaf's gap (`pick` max) or the median leaf's (`pick`
    statistics.median) between the program's norm and the reference's,
    each over the larger of the reference's norm of that leaf and of the
    median leaf."""
    leaves = list(leaves)
    if not leaves:
        return float("nan")
    med = statistics.median(ref[n] for n in leaves)
    return pick([abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                 for n in leaves])


def live_leaves(ref: dict) -> list:
    """The leaves the check reads: those whose largest gradient in the
    reference is not nought to rounding (NOUGHT)."""
    moved = [v for v in ref["grad_max"].values() if v > 0]
    floor = NOUGHT * statistics.median(moved) if moved else 0.0
    return sorted(n for n, v in ref["grad_max"].items()
                  if v >= floor and v > 0)


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 5) -> list:
    """The `n` leaves of `key` ('g1' or 'd3') with the largest gaps, each
    (name, gap, the program's norm, the reference's, the median leaf's):
    where a gap comes from, for PERF.md."""
    leaves = [x for x in live_leaves(ref) if ref[key][x] > 0]
    med = statistics.median(ref[key][x] for x in leaves)
    rows = [(x, abs(prog[key][x] - ref[key][x]) / max(ref[key][x], med),
             prog[key][x], ref[key][x], med) for x in leaves]
    return sorted(rows, key=lambda r: -r[1])[:n]


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap: the largest relative gap of a half's loss over the first
    three pairs; grad_gap: `_leaf_gap` of the first update; change_gap:
    `_leaf_gap` of the parameters' change after three pairs, and
    change_gap_median its median leaf's, steady where the sampled RoIs of
    pairs 2 and 3 follow rounding (PERF.md §4). A cell's limits file names
    the numbers it compares."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    live = live_leaves(ref)
    return {
        "loss_gap": max(losses) if all(np.isfinite(losses)) else float("inf"),
        "grad_gap": _leaf_gap(prog["g1"], ref["g1"],
                              (n for n in live if ref["g1"][n] > 0)),
        "change_gap": _leaf_gap(prog["d3"], ref["d3"], live),
        "change_gap_median": _leaf_gap(prog["d3"], ref["d3"], live,
                                       statistics.median),
    }


# a served detection is one of the reference's candidates where its box
# overlaps the reference's box of that label at some proposal by this much
MATCH_IOU = 0.99


def box_iou(a, b) -> np.ndarray:
    """Pairwise IoU of xyxy boxes a [N, 4] and b [M, 4], float64."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def detection_numbers(prog: dict, view: dict, score_thresh: float,
                      nms_thresh: float, k: int) -> dict:
    """One image's served detections (host arrays boxes [D, 4], scores
    [D], labels [D], valid [D]) judged by the reference's `view` of that
    image (predict.reference_view): `rescored`, the reference's probability
    of each served detection's label at the proposal its box was decoded
    from (NaN for a box on the image's edge, which is not judged);
    `candidates`, the reference's decoded box of every label at every
    proposal its RPN keeps [N, C, 4]; `dets`, its own detections.

    rescore_gap: the largest gap between a served score and the reference's
    score of that detection (box head). proposal_miss: the share of served
    detections whose box is none of the reference's candidates of its
    label (RPN, K5). miss_gap: the largest score by which a detection of
    the reference outranks what was served in its place, the served
    detection of its label that overlaps it beyond `nms_thresh`, or else the
    weakest served score (`score_thresh` where fewer than `k` were served)
    (K6: a pick left out, or the wrong one of two kept). nms_overlap: the
    largest IoU of two served detections of one label (K6's suppression)."""
    v = np.asarray(prog["valid"], bool).reshape(-1)
    ps = np.asarray(prog["scores"], np.float64).reshape(-1)[v]
    pb = np.asarray(prog["boxes"], np.float64).reshape(-1, 4)[v]
    pl = np.asarray(prog["labels"]).reshape(-1)[v].astype(np.int64)
    rs = np.asarray(view["rescored"], np.float64).reshape(-1)[v]
    if not (np.isfinite(pb).all() and np.isfinite(ps).all()):
        return {n: float("inf") for n in
                ("rescore_gap", "proposal_miss", "miss_gap", "nms_overlap")}
    gaps = np.abs(ps - rs)[~np.isnan(rs)]  # boxes on the edge: not judged
    out = {"rescore_gap": float(gaps.max()) if len(gaps) else 0.0}

    cand = np.asarray(view["candidates"], np.float64)  # [N, C, 4]
    stray = 0
    for label in np.unique(pl):
        mine = pb[pl == label]
        if not 1 <= label <= cand.shape[1] or not len(cand):
            stray += len(mine)
            continue
        best = box_iou(mine, cand[:, label - 1]).max(1)
        stray += int((best < MATCH_IOU).sum())
    out["proposal_miss"] = stray / len(pb) if len(pb) else 0.0

    ref = view["dets"]
    rv = np.asarray(ref["valid"], bool).reshape(-1)
    rb = np.asarray(ref["boxes"], np.float64).reshape(-1, 4)[rv]
    rsc = np.asarray(ref["scores"], np.float64).reshape(-1)[rv]
    rl = np.asarray(ref["labels"]).reshape(-1)[rv].astype(np.int64)
    floor = ps.min() if len(ps) >= k else score_thresh
    miss = 0.0
    if len(rb):
        same = rl[:, None] == pl[None, :]
        over = same & (box_iou(rb, pb) > nms_thresh)
        placed = np.where(over, ps[None, :], -np.inf).max(1, initial=-np.inf)
        miss = max(0.0, float((rsc - np.maximum(placed, floor)).max()))
    out["miss_gap"] = miss

    iou = box_iou(pb, pb)
    pair = (pl[:, None] == pl[None, :]) & ~np.eye(len(pb), dtype=bool)
    out["nms_overlap"] = float(np.where(pair, iou, 0.0).max(initial=0.0))
    return out


def worst(numbers: list) -> dict:
    """Each number's worst value over answers."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}
