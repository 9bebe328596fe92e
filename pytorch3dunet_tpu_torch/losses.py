"""Losses on NCDHW tensors (channel axis 1).

Counterparts of pytorch3dunet_tpu/losses.py (which is channels-last), the
whole registry: the V-Net Dice, the generalized Dice, BCE on logits, BCE +
Dice, (weighted) cross-entropy and the regression losses, with the same
wrapping rules of `get_loss_criterion` (MaskingLossWrapper for `ignore_index`
except on the cross-entropies, which take it themselves;
SkipLastTargetChannelWrapper for `skip_last_target`).

Targets are NCDHW like the logits, except for the cross-entropies, whose
targets are (N, D, H, W) integer class maps.
"""

import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.utils.misc import get_logger

logger = get_logger("Loss")


def flatten(tensor: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> (C, N * spatial): channel axis first, everything else flat."""
    return tensor.transpose(0, 1).reshape(tensor.shape[1], -1)


def compute_per_channel_dice(input, target, epsilon=1e-6, weight=None):
    """Per-channel Dice with the V-Net squared denominator; `input` holds
    normalized probabilities."""
    assert input.shape == target.shape, "'input' and 'target' must have the same shape"
    input = flatten(input)
    target = flatten(target).float()

    intersect = (input * target).sum(-1)
    if weight is not None:
        intersect = weight * intersect

    denominator = (input * input).sum(-1) + (target * target).sum(-1)
    return 2 * (intersect / denominator.clamp(min=epsilon))


class MaskingLossWrapper:
    """Zeros out input and target where target == ignore_index."""

    def __init__(self, loss, ignore_index):
        assert ignore_index is not None, "ignore_index cannot be None"
        self.loss = loss
        self.ignore_index = ignore_index

    def __call__(self, input, target):
        mask = (target != self.ignore_index).to(input.dtype)
        return self.loss(input * mask, target * mask)


class SkipLastTargetChannelWrapper:
    """Drops the last target channel before the loss."""

    def __init__(self, loss, squeeze_channel=False):
        self.loss = loss
        self.squeeze_channel = squeeze_channel

    def __call__(self, input, target):
        assert target.shape[1] > 1, "Target tensor has a singleton channel dimension, cannot remove channel"
        target = target[:, :-1]
        if self.squeeze_channel:
            target = target.squeeze(1)
        return self.loss(input, target)


def _as_tensor(values):
    return None if values is None else torch.as_tensor(values, dtype=torch.float32)


class _AbstractDiceLoss:
    """Base for Dice losses: normalization of the logits, then 1 - mean(dice)."""

    def __init__(self, weight=None, normalization="sigmoid"):
        self.weight = _as_tensor(weight)
        assert normalization in ["sigmoid", "softmax", "none"]
        self.normalization = normalization

    def _normalize(self, x):
        if self.normalization == "sigmoid":
            return torch.sigmoid(x)
        if self.normalization == "softmax":
            return torch.softmax(x, dim=1)
        return x

    def dice(self, input, target, weight):
        raise NotImplementedError

    def __call__(self, input, target):
        weight = None if self.weight is None else self.weight.to(input.device)
        return 1.0 - torch.mean(self.dice(self._normalize(input), target, weight=weight))


class DiceLoss(_AbstractDiceLoss):
    """Dice loss (arXiv:1606.04797); logits normalized by sigmoid by default."""

    def dice(self, input, target, weight):
        return compute_per_channel_dice(input, target, weight=weight)


class GeneralizedDiceLoss(_AbstractDiceLoss):
    """Generalized Dice Loss (arXiv:1707.03237) with inverse-volume weights;
    one channel is split into foreground and background."""

    def __init__(self, normalization="sigmoid", epsilon=1e-6):
        super().__init__(weight=None, normalization=normalization)
        self.epsilon = epsilon

    def dice(self, input, target, weight):
        assert input.shape == target.shape, "'input' and 'target' must have the same shape"
        input = flatten(input)
        target = flatten(target).float()

        if input.shape[0] == 1:
            # GDL needs at least 2 channels: split foreground/background
            input = torch.cat([input, 1 - input], dim=0)
            target = torch.cat([target, 1 - target], dim=0)

        w_l = target.sum(-1)
        w_l = (1.0 / (w_l * w_l).clamp(min=self.epsilon)).detach()

        intersect = (input * target).sum(-1) * w_l
        denominator = ((input + target).sum(-1) * w_l).clamp(min=self.epsilon)
        return 2 * (intersect.sum() / denominator.sum())


class BCEWithLogitsLoss:
    """Mean binary cross-entropy on logits, optional per-channel pos_weight."""

    def __init__(self, pos_weight=None):
        self.pos_weight = _as_tensor(pos_weight)

    def __call__(self, input, target):
        pos_weight = None
        if self.pos_weight is not None:
            # per channel: broadcast over the spatial axes, not the last one
            pos_weight = self.pos_weight.to(input.device).reshape(-1, *([1] * (input.ndim - 2)))
        return F.binary_cross_entropy_with_logits(input, target.to(input.dtype), pos_weight=pos_weight)


class BCEDiceLoss:
    """BCE + alpha * Dice on logits."""

    def __init__(self, alpha=1.0):
        self.alpha = alpha
        self.bce = BCEWithLogitsLoss()
        self.dice = DiceLoss()

    def __call__(self, input, target):
        return self.bce(input, target) + self.alpha * self.dice(input, target)


class CrossEntropyLoss:
    """Cross-entropy on (N, D, H, W) integer class maps with class weights and
    `ignore_index`: the weighted mean over the counted voxels, divided by
    their summed weights clamped at 1e-12, so a batch with every voxel ignored
    gives 0 (`F.cross_entropy` would give NaN)."""

    def __init__(self, weight=None, ignore_index=-100):
        self.weight = _as_tensor(weight)
        self.ignore_index = ignore_index

    def __call__(self, input, target):
        weight = None if self.weight is None else self.weight.to(input.device)
        return self._compute(input, target, weight)

    def _compute(self, input, target, weight):
        num_classes = input.shape[1]
        target = target.long()
        valid = target != self.ignore_index
        safe_target = torch.where(valid, target, 0)
        logp = F.log_softmax(input, dim=1)
        picked = logp.gather(1, safe_target.unsqueeze(1)).squeeze(1)
        if weight is not None:
            w = weight[safe_target.clamp(0, num_classes - 1)]
        else:
            w = torch.ones_like(picked)
        w = w * valid.to(picked.dtype)
        return -(w * picked).sum() / w.sum().clamp(min=1e-12)


class WeightedCrossEntropyLoss(CrossEntropyLoss):
    """WCE (arXiv:1707.03237): detached inverse-frequency class weights
    computed from the softmax of the input."""

    def __init__(self, ignore_index=-1):
        super().__init__(weight=None, ignore_index=ignore_index)

    def __call__(self, input, target):
        return self._compute(input, target, self._class_weights(input))

    @staticmethod
    def _class_weights(input):
        flattened = flatten(torch.softmax(input, dim=1))
        nominator = (1.0 - flattened).sum(-1)
        denominator = flattened.sum(-1)
        return (nominator / denominator).detach()


def _smooth_l1(diff, beta=1.0):
    abs_diff = diff.abs()
    return torch.where(abs_diff < beta, 0.5 * diff * diff / beta, abs_diff - 0.5 * beta)


class SmoothL1Loss:
    def __call__(self, input, target):
        return _smooth_l1(input - target.to(input.dtype)).mean()


class WeightedSmoothL1Loss:
    """SmoothL1 with a constant factor on the voxels whose target is below
    (or, with `apply_below_threshold: false`, at or above) a threshold."""

    def __init__(self, threshold, initial_weight, apply_below_threshold=True):
        self.threshold = threshold
        self.apply_below_threshold = apply_below_threshold
        self.weight = initial_weight

    def __call__(self, input, target):
        target = target.to(input.dtype)
        l1 = _smooth_l1(input - target)
        mask = target < self.threshold if self.apply_below_threshold else target >= self.threshold
        return torch.where(mask, l1 * self.weight, l1).mean()


class MSELoss:
    def __call__(self, input, target):
        diff = input - target.to(input.dtype)
        return (diff * diff).mean()


class L1Loss:
    def __call__(self, input, target):
        return (input - target.to(input.dtype)).abs().mean()


# the losses that take `ignore_index` themselves instead of MaskingLossWrapper
_CROSS_ENTROPIES = ("CrossEntropyLoss", "WeightedCrossEntropyLoss")


def get_loss_criterion(config):
    """Builds the loss from config['loss'] with the JAX package's wrapping
    rules (pytorch3dunet_tpu/losses.py `get_loss_criterion`)."""
    assert "loss" in config, "Could not find loss function configuration"
    loss_config = dict(config["loss"])
    name = loss_config.pop("name")
    logger.info(f"Creating loss function: {name}")

    ignore_index = loss_config.pop("ignore_index", None)
    skip_last_target = loss_config.pop("skip_last_target", False)
    weight = loss_config.pop("weight", None)
    pos_weight = loss_config.pop("pos_weight", None)

    if weight is not None:
        logger.info(f"Using class weights: {weight}")
    loss = _create_loss(name, loss_config, weight, ignore_index, pos_weight)

    if ignore_index is not None and name not in _CROSS_ENTROPIES:
        loss = MaskingLossWrapper(loss, ignore_index)
    if skip_last_target:
        loss = SkipLastTargetChannelWrapper(loss, loss_config.get("squeeze_channel", False))
    return loss


def _create_loss(name, loss_config, weight, ignore_index, pos_weight):
    normalization = loss_config.get("normalization", "sigmoid")
    if name == "BCEWithLogitsLoss":
        return BCEWithLogitsLoss(pos_weight=pos_weight)
    if name == "BCEDiceLoss":
        return BCEDiceLoss(loss_config.get("alpha", 1.0))
    if name in _CROSS_ENTROPIES:
        # through a config both default to -100 (WCE's own default of -1 never applies)
        ignore_index = -100 if ignore_index is None else ignore_index
        if name == "CrossEntropyLoss":
            return CrossEntropyLoss(weight=weight, ignore_index=ignore_index)
        return WeightedCrossEntropyLoss(ignore_index=ignore_index)
    if name == "GeneralizedDiceLoss":
        return GeneralizedDiceLoss(normalization=normalization)
    if name == "DiceLoss":
        return DiceLoss(weight=weight, normalization=normalization)
    if name == "WeightedSmoothL1Loss":
        return WeightedSmoothL1Loss(threshold=loss_config["threshold"], initial_weight=loss_config["initial_weight"],
                                    apply_below_threshold=loss_config.get("apply_below_threshold", True))
    simple = {"MSELoss": MSELoss, "SmoothL1Loss": SmoothL1Loss, "L1Loss": L1Loss}
    if name in simple:
        return simple[name]()
    raise RuntimeError(f"Unsupported loss function: '{name}'")
