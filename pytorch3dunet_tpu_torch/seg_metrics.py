"""Instance-level detection metrics (host numpy).

The port's own copy of pytorch3dunet_tpu/seg_metrics.py.

Semantics match the reference (pytorch3dunet/unet3d/seg_metrics.py:5-171) and
the Kaggle DSB2018 evaluation: an instance IoU matrix is built from a sparse
contingency table, a ground-truth instance counts as detected at threshold t
when some predicted instance overlaps it with IoU > t, and AveragePrecision
is the mean detection accuracy over IoU thresholds 0.50:0.05:0.95.

Unlike the reference's per-threshold loop, detection here is one vectorized
pass: the (T, n_gt, n_seg) hit tensor `iou[None] > thresholds[:, None, None]`
is reduced along instance axes to tp/fp/fn for every threshold at once.
"""

import numpy as np

from pytorch3dunet_tpu_torch.utils.ndimage import contingency_table


def _compact(labels: np.ndarray) -> np.ndarray:
    """Relabels instance ids to consecutive 0..K-1 (order preserving), so the
    contingency table stays as small as the number of distinct instances."""
    return np.unique(labels, return_inverse=True)[1].reshape(labels.shape)


def instance_iou(gt: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Dense IoU matrix between every gt and every predicted instance.

    Row/column 0 correspond to background (label 0 after compaction) and are
    kept so callers can slice them off explicitly.
    """
    overlap = contingency_table(_compact(gt), _compact(seg)).toarray()
    gt_sizes = overlap.sum(axis=1, keepdims=True)
    seg_sizes = overlap.sum(axis=0, keepdims=True)
    iou = overlap / (gt_sizes + seg_sizes - overlap)
    assert 0.0 <= iou.min() and iou.max() <= 1.0
    return iou


def detection_counts(iou: np.ndarray, thresholds) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tp, fp, fn) arrays, one entry per threshold, from an IoU matrix.

    Background (row/column 0) is excluded from matching. A gt instance is a
    true positive at threshold t if any predicted instance exceeds t against
    it; a predicted instance that exceeds t against no gt is a false positive.
    Only each instance's best IoU matters for these counts, so the detection
    pass reduces to two max-reductions compared against every threshold at
    once — O(n_gt * n_seg) total, not O(T * n_gt * n_seg).
    """
    foreground = iou[1:, 1:]
    n_gt, n_seg = foreground.shape
    thr = np.asarray(thresholds, dtype=np.float64)[:, None]
    best_gt = foreground.max(axis=1) if n_seg else np.zeros(n_gt)
    best_seg = foreground.max(axis=0) if n_gt else np.zeros(n_seg)
    tp = (best_gt[None, :] > thr).sum(axis=1)
    fp = n_seg - (best_seg[None, :] > thr).sum(axis=1)
    fn = n_gt - tp
    return tp, fp, fn


def _ratio(num, den):
    """Elementwise num/den with the reference's 0-when-no-tp convention."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    return np.where(num > 0, num / np.maximum(den, 1e-300), 0.0)


def precision(tp, fp, fn):
    return float(_ratio(tp, tp + fp))


def recall(tp, fp, fn):
    return float(_ratio(tp, tp + fn))


def accuracy(tp, fp, fn):
    return float(_ratio(tp, tp + fp + fn))


def f1(tp, fp, fn):
    return float(_ratio(2 * tp, 2 * tp + fp + fn))


class SegmentationMetrics:
    """Precision/recall/accuracy/F1 between a gt and a predicted instance
    segmentation at a given IoU threshold (reference seg_metrics.py:89-134)."""

    def __init__(self, gt, seg):
        self.iou_matrix = instance_iou(gt, seg)

    def metrics(self, iou_threshold: float) -> dict:
        tp, fp, fn = (int(c[0]) for c in detection_counts(self.iou_matrix, [iou_threshold]))
        return {
            "precision": precision(tp, fp, fn),
            "recall": recall(tp, fp, fn),
            "accuracy": accuracy(tp, fp, fn),
            "f1": f1(tp, fp, fn),
        }


class Accuracy:
    """Detection accuracy AC = TP / (TP + FP + FN) at a fixed IoU threshold
    (reference seg_metrics.py:137-153)."""

    def __init__(self, iou_threshold: float):
        self.iou_threshold = iou_threshold

    def __call__(self, input_seg, gt_seg) -> float:
        tp, fp, fn = detection_counts(instance_iou(gt_seg, input_seg), [self.iou_threshold])
        return float(_ratio(tp, tp + fp + fn)[0])


class AveragePrecision:
    """Mean detection accuracy over IoU 0.50:0.05:0.95 — the DSB2018 metric
    (reference seg_metrics.py:156-171) — computed in one vectorized pass."""

    iou_range = np.linspace(0.50, 0.95, 10)

    def __call__(self, input_seg, gt_seg) -> float:
        tp, fp, fn = detection_counts(instance_iou(gt_seg, input_seg), self.iou_range)
        return float(_ratio(tp, tp + fp + fn).mean())
