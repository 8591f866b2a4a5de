"""Detector evaluation: PR curves, AUC, per-image NMS + GT matching.

Parity with /root/reference/waldboost/testing.py (Evaluator, evaluate_model,
detect_on_images, random_iterator — including the reference's `cycle` import
bitrot fixed, SURVEY.md appendix).
"""

from __future__ import annotations

import logging
import random
from itertools import islice
from typing import Any, Sequence

import numpy as np

from . import boxes as bbx
from .boxes import Boxes

__all__ = ["Evaluator", "evaluate_model", "detect_on_images", "random_iterator", "ulp_distance",
           "precision_recall", "auc"]


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise ULP distance between two float32 arrays: 0 = bitwise
    equal, 1 = adjacent representables.  Negative floats are remapped onto
    the monotone integer line so sign crossings count correctly.  Shared by
    the float-image golden test, PARITY.md's ULP bound and chip_smoke.py's
    GPU-vs-CPU channel comparison, so every bound uses ONE definition."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return np.abs(ai - bi)


def precision_recall(y_true: np.ndarray, scores: np.ndarray):
    """Precision-recall curve over descending score thresholds.

    Equivalent to sklearn.metrics.precision_recall_curve (used by the
    reference at /root/reference/waldboost/testing.py:72) but dependency-free:
    returns (precision, recall, thresholds) with the same conventions
    (appended P=1, R=0 sentinel; thresholds ascending unique scores).
    """
    y_true = np.asarray(y_true, bool).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    s = scores[order]
    tp = np.cumsum(y)
    fp = np.cumsum(~y)
    # threshold boundaries: last occurrence of each distinct score
    distinct = np.nonzero(np.diff(s))[0]
    idx = np.concatenate([distinct, [s.size - 1]])
    tp_t = tp[idx]
    fp_t = fp[idx]
    total_pos = tp[-1] if tp.size else 0
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp_t + fp_t > 0, tp_t / (tp_t + fp_t), 1.0)
        recall = tp_t / total_pos if total_pos > 0 else np.zeros_like(tp_t, float)
    # sklearn returns in increasing-threshold order with a (1, 0) sentinel
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    thresholds = s[idx][::-1]
    return precision, recall, thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under the curve (sklearn.metrics.auc equivalent):
    direction-aware, preserving the order of tied x points."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.size < 2:
        return 0.0
    dx = np.diff(x)
    if np.all(dx <= 0):
        return float(-np.trapezoid(y, x))
    if np.all(dx >= 0):
        return float(np.trapezoid(y, x))
    order = np.argsort(x, kind="stable")
    return float(np.trapezoid(y[order], x[order]))


class Evaluator:
    """Accumulates per-image GT + detections; computes pooled PR/AUC at an IoU
    threshold (/root/reference/waldboost/testing.py:18-81)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.eval_data = dict()

    def add_ground_truth(self, idx, boxes: Boxes, shape):
        self.eval_data.setdefault(idx, dict()).update(gt=boxes, shape=shape)

    def add_detections(self, idx, boxes: Boxes):
        self.eval_data.setdefault(idx, dict()).update(dt=boxes)

    @staticmethod
    def _gt_ignore_mask(gt_boxes: Boxes, image_hw, min_gt_area,
                        min_gt_area_in_image) -> np.ndarray:
        """A GT box is excluded from scoring when flagged ``ignore``, when
        smaller than ``min_gt_area``, or when less than
        ``min_gt_area_in_image`` of it lies inside the image."""
        if not len(gt_boxes):
            return np.zeros(0, bool)
        h, w = image_hw
        out = np.zeros(len(gt_boxes), bool)
        if gt_boxes.has_field("ignore"):
            out |= np.asarray(gt_boxes.get_field("ignore")).reshape(-1) != 0
        out |= gt_boxes.area() < min_gt_area
        frame = Boxes(np.array([0, 0, w, h], "f"))
        out |= ~bbx.boxes_in_window(gt_boxes, frame,
                                    min_overlap=min_gt_area_in_image)
        return out

    @staticmethod
    def _score_one_image(gt_boxes, gt_ignore, dt_boxes, dt_scores,
                         match_iou_threshold):
        """Greedy best-IoU assignment: each detection claims its best GT;
        detections whose best GT is ignored drop out of the PR pool, the
        rest are TP iff the best IoU clears the threshold."""
        overlaps = bbx.iou(gt_boxes, dt_boxes)
        if overlaps.shape[0] == 0:
            return np.zeros(len(dt_boxes), bool), dt_scores
        best_gt = overlaps.argmax(axis=0)
        keep = ~gt_ignore[best_gt]
        is_tp = overlaps.max(axis=0) > match_iou_threshold
        return is_tp[keep], dt_scores[keep]

    def evaluate(self, match_iou_threshold=0.5, dt_iou_threshold=0.5,
                 min_gt_area=0, min_gt_area_in_image=1, normalize_ar=None):
        pool_tp, pool_score, pool_ign = [], [], []
        for img_result in self.eval_data.values():
            gt_boxes = img_result["gt"]
            gt_ignore = self._gt_ignore_mask(
                gt_boxes, img_result["shape"], min_gt_area,
                min_gt_area_in_image)

            dt_boxes = bbx.non_max_suppression(img_result["dt"],
                                               iou_threshold=dt_iou_threshold)
            dt_scores = np.asarray(dt_boxes.get_field("scores")).reshape(-1)

            if normalize_ar is not None:
                dt_boxes = bbx.set_aspect_ratio(dt_boxes, normalize_ar)
                gt_boxes = bbx.set_aspect_ratio(gt_boxes, normalize_ar)

            is_tp, score = self._score_one_image(
                gt_boxes, gt_ignore, dt_boxes, dt_scores,
                match_iou_threshold)
            pool_tp.append(is_tp)
            pool_score.append(score)
            pool_ign.append(gt_ignore)

        y_true = np.concatenate(pool_tp) if pool_tp else np.zeros(0, bool)
        y_score = np.concatenate(pool_score) if pool_score else np.zeros(0)
        ignored = np.concatenate(pool_ign) if pool_ign else np.zeros(0, bool)

        p, r, t = precision_recall(y_true, y_score)
        return dict(
            precision=p.tolist(), recall=r.tolist(), threshold=t.tolist(),
            auc=auc(r, p),
            iou_threshold=match_iou_threshold,
            n_eval=int((ignored == 0).sum()),
            n_ign=int((ignored != 0).sum()),
        )


def random_iterator(seq: Sequence[Any], maxlen=None):
    """Yield elements of an indexable sequence in a shuffled order, cycling
    through the same permutation indefinitely; ``maxlen`` caps the total
    yield count.  (API parity with the reference's helper at
    /root/reference/waldboost/testing.py:84-96, whose missing ``cycle``
    import is bitrot — SURVEY.md appendix.)"""
    try:
        n = len(seq)
        seq[0] if n else None
    except TypeError:
        raise TypeError("random_iterator needs an indexable sequence")
    perm = random.sample(range(n), n)
    if not perm:
        return
    count = 0
    while True:
        for j in perm:
            if maxlen is not None and count > maxlen:
                return
            count += 1
            yield seq[j]


def detect_on_images(images, *model, gt_key="groundtruth_boxes"):
    """Adapt a stream of dataset dicts into per-image evaluation triples
    ``(gt_boxes, dt_boxes, image_hw)``, running multi-model detection on
    each (/root/reference/waldboost/testing.py:127-133 is the API
    anchor)."""
    from . import detect

    for record in images:
        image = record["image"]
        gt = record.get(gt_key)
        if gt is None:
            gt = Boxes(np.empty((0, 4), "f"), ignore=np.empty(0, "i"))
        yield gt, detect(image, *model), image.shape[:2]


def evaluate_model(testing_images, *model, num_images=None, shuffle=False):
    """Score the model(s) on a test set and return the filled
    :class:`Evaluator` (call ``.evaluate()`` on it for PR/AUC).  API anchor:
    /root/reference/waldboost/testing.py:99-124."""
    if num_images is None:
        try:
            num_images = len(testing_images)
        except TypeError:
            raise ValueError(
                "evaluate_model needs num_images for unsized datasets")
    stream = random_iterator(testing_images) if shuffle else \
        iter(testing_images)

    ev = Evaluator()
    logging.info("evaluating detector on %d images", num_images)
    n_seen = 0
    for gt, dt, shape in detect_on_images(
            islice(stream, num_images), *model):
        n_seen += 1
        ev.add_ground_truth(n_seen, gt, shape)
        ev.add_detections(n_seen, dt)
        if n_seen % 20 == 0:
            logging.info("  %d/%d", n_seen, num_images)
    if n_seen != num_images:
        logging.warning("dataset ran dry at %d of the requested %d images",
                        n_seen, num_images)
    return ev
