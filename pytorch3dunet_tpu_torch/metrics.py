"""Evaluation metric registry: Dice, MeanIoU, AdaptedRand, AveragePrecision, PSNR, MSE.

The port's own copy of the numpy metric classes of pytorch3dunet_tpu/metrics.py,
with parity to the reference (pytorch3dunet/unet3d/metrics.py). Metrics run on
the host at validation cadence — exactly as the reference, which leaves the
device at metrics.py:131,299 — so they are numpy implementations on
channels-first (N, C, D, H, W) arrays, the port's layout.

`device_metric_fn` gives the device twins of the reduction-only metrics
(Dice, MeanIoU, MSE, PSNR): torch functions on the device tensors, so that a
validation batch leaves one 0-d tensor on the device instead of sending its
probability volume to the host.
"""

import numpy as np
import torch

from pytorch3dunet_tpu_torch.seg_metrics import Accuracy, AveragePrecision
from pytorch3dunet_tpu_torch.utils.misc import get_class, get_logger
from pytorch3dunet_tpu_torch.utils.ndimage import (
    adapted_rand_error,
    label,
    mean_squared_error,
    peak_signal_noise_ratio,
)

logger = get_logger("EvalMetric")


# --------------------------------------------------------------------------
# small shared pieces (threshold handling, connected components, channel
# selection) used by several metric families below


def _threshold_list(thresholds, default):
    """Validated probability-threshold list with a per-metric default."""
    if thresholds is None:
        return list(default)
    assert isinstance(thresholds, list)
    return thresholds


def _connected_components(mask):
    """Labels a boolean/uint8 foreground mask (4-connectivity, bg=0)."""
    return label(np.ascontiguousarray(mask, dtype=np.uint8), background=0, connectivity=1)


def _threshold_and_label(pmap, thresholds, invert=False):
    """Segmentations from one probability map: one connected-components pass
    per threshold; `invert` treats the ABOVE-threshold region as background
    (boundary maps: cells are the space between boundaries)."""
    fg_masks = ((pmap <= th) if invert else (pmap > th) for th in thresholds)
    return [_connected_components(m) for m in fg_masks]


def _squeeze_target_channel(target, use_last):
    """(N, C, ...) -> (N, ...): the label channel is either the last one
    (use_last_target — extra channels carry auxiliary training targets) or
    the first."""
    return target[:, -1 if use_last else 0, ...]


def _sq_sum(a, axes):
    return np.sum(a * a, axis=axes)


def _channel_dice(pred, truth, epsilon):
    """Per-channel V-Net Dice (squared-denominator) on probabilities."""
    n_ch = pred.shape[1]
    p = np.moveaxis(pred, 1, 0).reshape(n_ch, -1).astype(np.float64)
    t = np.moveaxis(truth, 1, 0).reshape(n_ch, -1).astype(np.float64)
    overlap = np.einsum("ij,ij->i", p, t)
    norm = _sq_sum(p, -1) + _sq_sum(t, -1)
    return 2.0 * overlap / np.clip(norm, epsilon, None)


class DiceCoefficient:
    """Mean per-channel Dice on probabilities (metrics.py:15-27)."""

    def __init__(self, epsilon=1e-6, **kwargs):
        self.epsilon = epsilon

    def __call__(self, pred, truth):
        pred, truth = np.asarray(pred), np.asarray(truth)
        assert pred.shape == truth.shape
        return float(np.mean(_channel_dice(pred, truth, self.epsilon)))


class MeanIoU:
    """Per-class IoU averaged over classes and the batch (metrics.py:30-98).

    4D integer targets: input argmax over channels, background optionally
    skipped. 5D targets: per-channel IoU at a 0.5 threshold, background kept.
    """

    def __init__(self, skip_background=True, **kwargs):
        self.skip_background = skip_background

    @staticmethod
    def _iou(pred_mask, truth_mask):
        eps = 1e-8
        overlap = np.count_nonzero(pred_mask & truth_mask)
        union = np.count_nonzero(pred_mask | truth_mask)
        return (overlap + eps) / (union + eps)

    def _volume_iou(self, pred, truth, n_classes, channelwise):
        if channelwise:
            classes = range(n_classes)
            pairs = ((pred[c] > 0.5, truth[c].astype(bool)) for c in classes)
        else:
            classes = range(1 if self.skip_background else 0, n_classes)
            pairs = ((pred == c, truth == c) for c in classes)
        scores = [self._iou(p, t) for p, t in pairs]
        assert scores, "every class was excluded from the IoU computation"
        return np.mean(scores)

    def __call__(self, pred, truth):
        pred, truth = np.asarray(pred), np.asarray(truth)
        assert pred.ndim == 5
        n_classes = pred.shape[1]
        channelwise = truth.ndim == 5
        if not channelwise:
            pred = pred.argmax(axis=1)
        assert pred.shape == truth.shape
        return float(np.mean(
            [self._volume_iou(p, t, n_classes, channelwise) for p, t in zip(pred, truth)]
        ))


class AdaptedRandError:
    """Adapted Rand error between a predicted segmentation and ground truth
    (metrics.py:101-179). Subclasses define input_to_segm()."""

    def __init__(self, use_last_target=False, ignore_index=None, **kwargs):
        self.use_last_target = use_last_target
        self.ignore_index = ignore_index

    def _volume_arand(self, pred, truth):
        if (truth == truth.flat[0]).all():
            # a constant ground truth makes the Rand score degenerate
            logger.info("ARand skipped: ground truth contains a single label")
            return 0.0
        candidates = self.input_to_segm(pred)
        assert candidates.ndim == 4
        # best (minimum error) candidate segmentation wins
        return min(adapted_rand_error(truth, seg)[0] for seg in candidates)

    def __call__(self, pred, truth):
        pred = np.asarray(pred)
        truth = _squeeze_target_channel(np.asarray(truth), self.use_last_target).astype(np.int32)
        if self.ignore_index is not None:
            truth = np.where(truth == self.ignore_index, 0, truth)
        score = float(np.mean([self._volume_arand(p, t) for p, t in zip(pred, truth)]))
        logger.info(f"ARand: {score}")
        return score

    def input_to_segm(self, pred):
        # the network output is taken to already be a segmentation volume
        return pred


class BoundaryAdaptedRandError(AdaptedRandError):
    """ARand from a boundary probability map: threshold, invert, connected
    components (metrics.py:182-234)."""

    def __init__(self, thresholds=None, use_last_target=True, ignore_index=None, input_channel=None,
                 invert_pmaps=True, **kwargs):
        super().__init__(use_last_target=use_last_target, ignore_index=ignore_index, **kwargs)
        self.thresholds = _threshold_list(thresholds, (0.3, 0.4, 0.5, 0.6))
        self.input_channel = input_channel
        self.invert_pmaps = invert_pmaps

    def input_to_segm(self, pred):
        channels = pred if self.input_channel is None else pred[self.input_channel][None]
        return np.stack([
            seg
            for pmap in channels
            for seg in _threshold_and_label(pmap, self.thresholds, invert=self.invert_pmaps)
        ])


class GenericAdaptedRandError(AdaptedRandError):
    """ARand over selected (optionally inverted) input channels (metrics.py:237-271)."""

    def __init__(self, input_channels, thresholds=None, use_last_target=True, ignore_index=None,
                 invert_channels=None, **kwargs):
        super().__init__(use_last_target=use_last_target, ignore_index=ignore_index, **kwargs)
        assert isinstance(input_channels, (list, tuple))
        self.input_channels = input_channels
        self.thresholds = _threshold_list(thresholds, (0.3, 0.4, 0.5, 0.6))
        self.invert_channels = invert_channels or []

    def input_to_segm(self, pred):
        pmaps = [
            1 - pred[i] if i in self.invert_channels else pred[i]
            for i in self.input_channels
        ]
        return np.stack([
            seg for pmap in pmaps for seg in _threshold_and_label(pmap, self.thresholds)
        ])


class GenericAveragePrecision:
    """Average precision of an instance segmentation derived from the network
    output (metrics.py:274-348)."""

    def __init__(self, min_instance_size=None, use_last_target=False, metric="ap", **kwargs):
        self.min_instance_size = min_instance_size
        self.use_last_target = use_last_target
        assert metric in ["ap", "acc"]
        self.metric = AveragePrecision() if metric == "ap" else Accuracy(iou_threshold=0.5)

    def _volume_ap(self, idx, pred, truth):
        candidates = self.input_to_seg(pred, truth)
        assert candidates.ndim == 4
        gt_seg = self._filter_instances(self.target_to_seg(truth))
        scores = [self.metric(self._filter_instances(seg), gt_seg) for seg in candidates]
        logger.info(f"Batch: {idx}. Max Average Precision for channel: {np.argmax(scores)}")
        return np.max(scores)

    def __call__(self, pred, truth):
        truth = np.asarray(truth)
        if truth.ndim == 5:
            truth = _squeeze_target_channel(truth, self.use_last_target)
        # multi-head nets (e.g. blob + boundary) hand a tuple of outputs to
        # input_to_seg as a pair; single-head nets hand the array itself
        if isinstance(pred, tuple):
            per_volume = list(zip(*(np.asarray(p) for p in pred)))
        else:
            per_volume = list(np.asarray(pred))
        return float(np.mean(
            [self._volume_ap(i, p, t) for i, (p, t) in enumerate(zip(per_volume, truth))]
        ))

    def _filter_instances(self, seg):
        """Relabels instances smaller than min_instance_size to background."""
        if self.min_instance_size is None:
            return seg
        ids, sizes = np.unique(seg, return_counts=True)
        small = ids[sizes < self.min_instance_size]
        return np.where(np.isin(seg, small), 0, seg)

    def input_to_seg(self, pred, truth=None):
        raise NotImplementedError

    def target_to_seg(self, truth):
        return truth


class BlobsAveragePrecision(GenericAveragePrecision):
    """AP from a foreground probability map (metrics.py:351-377)."""

    def __init__(self, thresholds=None, metric="ap", min_instance_size=None, input_channel=0, **kwargs):
        super().__init__(min_instance_size=min_instance_size, use_last_target=True, metric=metric)
        self.thresholds = _threshold_list(thresholds, (0.4, 0.5, 0.6, 0.7, 0.8))
        self.input_channel = input_channel

    def input_to_seg(self, pred, truth=None):
        return np.stack(_threshold_and_label(pred[self.input_channel], self.thresholds))


class BlobsBoundaryAveragePrecision(GenericAveragePrecision):
    """AP from (P_mask - P_boundary) > threshold (metrics.py:380-407)."""

    def __init__(self, thresholds=None, metric="ap", min_instance_size=None, **kwargs):
        super().__init__(min_instance_size=min_instance_size, use_last_target=True, metric=metric)
        self.thresholds = _threshold_list(thresholds, (0.3, 0.4, 0.5, 0.6, 0.7))

    def input_to_seg(self, pred, truth=None):
        # cells are where the mask probability clears the boundary probability
        return np.stack(_threshold_and_label(pred[0] - pred[1], self.thresholds))


class BoundaryAveragePrecision(GenericAveragePrecision):
    """AP from an inverted boundary probability map (metrics.py:410-433)."""

    def __init__(self, thresholds=None, min_instance_size=None, input_channel=0, **kwargs):
        super().__init__(min_instance_size=min_instance_size, use_last_target=True)
        self.thresholds = _threshold_list(thresholds, (0.3, 0.4, 0.5, 0.6))
        self.input_channel = input_channel

    def input_to_seg(self, pred, truth=None):
        return np.stack(
            _threshold_and_label(pred[self.input_channel], self.thresholds, invert=True)
        )


class PSNR:
    """Peak signal-to-noise ratio, e.g. for denoising eval (metrics.py:436-447)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, pred, truth):
        return float(peak_signal_noise_ratio(np.asarray(truth), np.asarray(pred)))


class MSE:
    """Mean squared error (metrics.py:450-458)."""

    def __init__(self, **kwargs):
        pass

    def __call__(self, pred, truth):
        return float(mean_squared_error(np.asarray(pred), np.asarray(truth)))


def _dice_twin(epsilon):
    def dice(probs, target):
        non_channel = (0, *range(2, probs.ndim))
        p, t = probs.float(), target.float()
        intersect = (p * t).sum(non_channel)
        denominator = (p * p).sum(non_channel) + (t * t).sum(non_channel)
        return (2.0 * intersect / denominator.clamp(min=epsilon)).mean()

    return dice


def _mean_iou_twin(skip_background):
    epsilon = 1e-8

    def iou(pred, tar, spatial):
        inter = (pred & tar).sum(spatial)
        union = (pred | tar).sum(spatial)
        return (inter + epsilon) / (union + epsilon)

    def mean_iou(probs, target):
        if target.ndim == probs.ndim:  # channelwise: each channel at 0.5
            return iou(probs > 0.5, target != 0, tuple(range(2, probs.ndim))).mean()
        pred_cls = probs.argmax(dim=1)  # the first maximum, as np.argmax
        spatial = tuple(range(1, pred_cls.ndim))
        first = 1 if skip_background else 0
        return torch.stack([iou(pred_cls == c, target == c, spatial) for c in range(first, probs.shape[1])]).mean()

    return mean_iou


def _mse_twin(probs, target):
    return ((probs.float() - target.float()) ** 2).mean()


def _psnr_twin(probs, target):
    t, p = target.float(), probs.float()
    data_range = torch.where(t.min() >= 0, 1.0, 2.0)
    err = ((t - p) ** 2).mean()
    return torch.where(err == 0, torch.inf, 10.0 * torch.log10(data_range**2 / err.clamp(min=1e-38)))


def device_metric_fn(criterion):
    """The device twin of `criterion`, or None (JAX metrics.py
    `device_metric_fn`).

    A twin takes the model's NCDHW probabilities and the target on the device
    (a class map has no channel axis) and returns a 0-d float32 tensor there,
    equal to the host metric up to f32 rounding. The metrics that need host
    algorithms (connected components, adapted rand, average precision) have
    none and run on the host."""
    if type(criterion) is DiceCoefficient:
        return _dice_twin(criterion.epsilon)
    if type(criterion) is MeanIoU:
        return _mean_iou_twin(criterion.skip_background)
    if type(criterion) is MSE:
        return _mse_twin
    if type(criterion) is PSNR:
        return _psnr_twin
    return None


def get_evaluation_metric(config):
    """Builds the eval metric from config['eval_metric'] (metrics.py:461-479)."""
    spec = config.get("eval_metric")
    assert spec is not None, "config is missing the 'eval_metric' section"
    cls = get_class(spec["name"], modules=["pytorch3dunet_tpu_torch.metrics"])
    return cls(**spec)
