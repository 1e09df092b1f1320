"""Segmentation quality metrics.

Boundary F-measure between two segmentations — the acceptance metric for
this rebuild (>= 0.95 vs the reference's output at matched settings,
BASELINE.md): precision/recall of boundary pixels with a small spatial
tolerance, as in the BSDS boundary benchmark.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def boundary_map(labels: np.ndarray) -> np.ndarray:
    """(H,W) labels -> bool boundary map (N4 label changes)."""
    b = np.zeros(labels.shape, bool)
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    return b


def boundary_f_measure(labels_a: np.ndarray, labels_b: np.ndarray,
                       tolerance: int = 2) -> dict:
    """Boundary precision/recall/F between label images (or (T,H,W) stacks).

    A boundary pixel matches if the other segmentation has any boundary
    pixel within `tolerance` (chebyshev) — evaluated by dilation.
    """
    if labels_a.ndim == 2:
        labels_a = labels_a[None]
        labels_b = labels_b[None]
    size = 2 * tolerance + 1
    tp_p = 0
    n_p = 0
    tp_r = 0
    n_r = 0
    for la, lb in zip(labels_a, labels_b):
        ba = boundary_map(la)
        bb = boundary_map(lb)
        bb_d = ndimage.maximum_filter(bb, size, mode="constant")
        ba_d = ndimage.maximum_filter(ba, size, mode="constant")
        tp_p += int((ba & bb_d).sum())
        n_p += int(ba.sum())
        tp_r += int((bb & ba_d).sum())
        n_r += int(bb.sum())
    precision = tp_p / max(n_p, 1)
    recall = tp_r / max(n_r, 1)
    f = (2 * precision * recall / max(precision + recall, 1e-12))
    return {"precision": precision, "recall": recall, "f_measure": f}


def segmentation_covering(labels_a: np.ndarray, labels_b: np.ndarray) -> float:
    """Best-overlap region covering of b by a (per-frame, area-weighted)."""
    if labels_a.ndim == 2:
        labels_a = labels_a[None]
        labels_b = labels_b[None]
    total = 0.0
    area = 0
    for la, lb in zip(labels_a, labels_b):
        _, ia = np.unique(la, return_inverse=True)
        _, ib = np.unique(lb, return_inverse=True)
        ia = ia.ravel()
        ib = ib.ravel()
        na = ia.max() + 1
        nb = ib.max() + 1
        joint = np.bincount(ia * nb + ib, minlength=na * nb).reshape(na, nb)
        sa = joint.sum(1)
        sb = joint.sum(0)
        iou = joint / np.maximum(sa[:, None] + sb[None, :] - joint, 1)
        total += float((sb * iou.max(0)).sum())
        area += int(lb.size)
    return total / max(area, 1)
