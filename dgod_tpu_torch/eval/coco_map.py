"""COCO-style mAP@0.5 evaluator (torchmetrics / pycocotools parity); the
port's own copy of dgod_tpu/eval/coco_map.py.

Reproduces `torchmetrics.detection.MeanAveragePrecision(iou_type="bbox",
class_metrics=True, iou_thresholds=[0.5])` as used by the reference at
DGcommon.py:127,168-172 — greedy per-image matching, global score-sorted
accumulation, 101-point interpolated AP per class, classes with no GT
excluded from the mean.

Host-side numpy: the metric runs on CPU in the reference too (pycocotools C
extension); detection counts are tiny (<=100/image) so this is never the
bottleneck. Inputs are padded arrays + validity masks straight from the
eval step.
"""

from __future__ import annotations

import numpy as np

_REC_THRS = np.linspace(0.0, 1.0, 101)


def _iou_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU [D, G] for xyxy boxes."""
    if len(det_boxes) == 0 or len(gt_boxes) == 0:
        return np.zeros((len(det_boxes), len(gt_boxes)))
    lt = np.maximum(det_boxes[:, None, :2], gt_boxes[None, :, :2])
    rb = np.minimum(det_boxes[:, None, 2:], gt_boxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    area_g = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    out = np.zeros_like(inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


class MeanAveragePrecision:
    """Streaming mAP@iou_threshold with per-class results.

    update() per image (or per batch of images); compute() returns
    {"map_50": float, "map_per_class": np.ndarray, "classes": np.ndarray}.
    """

    def __init__(self, iou_threshold: float = 0.5, max_detections: int = 100):
        self.iou_threshold = iou_threshold
        self.max_detections = max_detections
        self.reset()

    def reset(self):
        self._preds = []  # list of (boxes, scores, labels) per image
        self._targets = []  # list of (boxes, labels) per image

    def update(self, pred_boxes, pred_scores, pred_labels, gt_boxes, gt_labels,
               pred_valid=None, gt_valid=None):
        """Add one image. Arrays may be padded; pass validity masks to trim."""
        pred_boxes = np.asarray(pred_boxes, dtype=np.float64)
        pred_scores = np.asarray(pred_scores, dtype=np.float64)
        pred_labels = np.asarray(pred_labels)
        gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
        gt_labels = np.asarray(gt_labels)
        if pred_valid is not None:
            m = np.asarray(pred_valid, bool)
            pred_boxes, pred_scores, pred_labels = pred_boxes[m], pred_scores[m], pred_labels[m]
        if gt_valid is not None:
            m = np.asarray(gt_valid, bool)
            gt_boxes, gt_labels = gt_boxes[m], gt_labels[m]
        self._preds.append((pred_boxes, pred_scores, pred_labels))
        self._targets.append((gt_boxes, gt_labels))

    def _evaluate_class(self, cls):
        """Greedy matching per image for one class; returns global PR stats."""
        thr = self.iou_threshold
        all_scores, all_matched = [], []
        n_gt = 0
        for (db, ds, dl), (gb, gl) in zip(self._preds, self._targets):
            dm = dl == cls
            gm = gl == cls
            det_b, det_s = db[dm], ds[dm]
            gt_b = gb[gm]
            n_gt += len(gt_b)
            if len(det_b) == 0:
                continue
            # per-image: sort by score desc (stable), cap at maxDets
            order = np.argsort(-det_s, kind="stable")[: self.max_detections]
            det_b, det_s = det_b[order], det_s[order]
            ious = _iou_matrix(det_b, gt_b)
            gt_taken = np.zeros(len(gt_b), bool)
            matched = np.zeros(len(det_b), bool)
            min_iou = min(thr, 1.0 - 1e-10)
            for d in range(len(det_b)):
                # pycocotools: best-IoU untaken gt with iou >= thr,
                # ties resolved to the LAST gt index
                if not len(gt_b):
                    break
                cand = np.where(gt_taken, -1.0, ious[d])
                mx = cand.max()
                if mx >= min_iou:
                    best_g = len(cand) - 1 - int(np.argmax(cand[::-1]))
                    gt_taken[best_g] = True
                    matched[d] = True
            all_scores.append(det_s)
            all_matched.append(matched)

        if n_gt == 0:
            return None  # class absent from GT -> excluded from the mean
        if not all_scores:
            return 0.0
        scores = np.concatenate(all_scores)
        matched = np.concatenate(all_matched)
        order = np.argsort(-scores, kind="mergesort")
        matched = matched[order]
        tp = np.cumsum(matched)
        fp = np.cumsum(~matched)
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        # make precision monotonically non-increasing from the right
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        # 101-point interpolation
        inds = np.searchsorted(recall, _REC_THRS, side="left")
        q = np.zeros(len(_REC_THRS))
        valid = inds < len(precision)
        q[valid] = precision[inds[valid]]
        return float(q.mean())

    def compute(self):
        classes = sorted(
            set(
                int(c)
                for (_, _, dl) in self._preds
                for c in np.unique(dl)
            )
            | set(int(c) for (_, gl) in self._targets for c in np.unique(gl))
        )
        per_class = []
        kept_classes = []
        for cls in classes:
            ap = self._evaluate_class(cls)
            kept_classes.append(cls)
            per_class.append(-1.0 if ap is None else ap)
        per_class = np.asarray(per_class, dtype=np.float64)
        valid = per_class > -1
        map_50 = float(per_class[valid].mean()) if valid.any() else -1.0
        return {
            "map_50": map_50,
            "map_per_class": per_class,
            "classes": np.asarray(kept_classes),
        }
