"""Segmentation quality metrics (Dice, SEG, object-level F1).

Port of :mod:`superdsm_tpu.metrics`: host numpy code, carried over as is.
These are the standard definitions of the cell-segmentation benchmarks
(the reference's papers report Dice and SEG), so results can be scored
against reference label maps directly.
"""

import numpy as np


def dice(actual, expected):
    """Global foreground Dice coefficient of two label maps (0 = background)."""
    a = np.asarray(actual) > 0
    b = np.asarray(expected) > 0
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0
    return 2.0 * np.logical_and(a, b).sum() / denom


def seg_score(actual, expected):
    """SEG measure (Cell Tracking Challenge): mean over ground-truth objects
    of the IoU with their matched segmented object, where a match requires
    the segmented object to cover more than half of the ground-truth object.
    """
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    gt_labels = np.unique(expected)
    gt_labels = gt_labels[gt_labels > 0]
    if len(gt_labels) == 0:
        return 1.0 if not (actual > 0).any() else 0.0
    scores = []
    for gt in gt_labels:
        gt_mask = expected == gt
        overlap_labels, counts = np.unique(actual[gt_mask], return_counts=True)
        best = 0.0
        for label, count in zip(overlap_labels, counts):
            if label == 0:
                continue
            if count > 0.5 * gt_mask.sum():
                seg_mask = actual == label
                best = np.logical_and(gt_mask, seg_mask).sum() / \
                    np.logical_or(gt_mask, seg_mask).sum()
                break
        scores.append(best)
    return float(np.mean(scores))


def object_based_f1(actual, expected, iou_threshold=0.5):
    """Object-level precision/recall/F1 by greedy IoU matching.

    :return: dict with ``precision``, ``recall``, ``f1``, ``matches``.
    """
    actual = np.asarray(actual)
    expected = np.asarray(expected)
    a_labels = [l for l in np.unique(actual) if l > 0]
    e_labels = [l for l in np.unique(expected) if l > 0]
    matched_a, matched_e = set(), set()
    matches = 0
    for e in e_labels:
        e_mask = expected == e
        cand, counts = np.unique(actual[e_mask], return_counts=True)
        order = np.argsort(-counts)
        for idx in order:
            label = cand[idx]
            if label == 0 or label in matched_a:
                continue
            a_mask = actual == label
            iou = np.logical_and(a_mask, e_mask).sum() / \
                np.logical_or(a_mask, e_mask).sum()
            if iou >= iou_threshold:
                matched_a.add(label)
                matched_e.add(e)
                matches += 1
            break
    precision = matches / len(a_labels) if a_labels else 1.0
    recall = matches / len(e_labels) if e_labels else 1.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {'precision': precision, 'recall': recall, 'f1': f1, 'matches': matches}
