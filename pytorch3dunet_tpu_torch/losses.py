"""Losses of the training path on NCDHW tensors (channel axis 1).

Counterparts of pytorch3dunet_tpu/losses.py (which is channels-last): the
V-Net Dice, BCE on logits and BCE + Dice, with the same wrapping rules of
`get_loss_criterion` (MaskingLossWrapper for `ignore_index`,
SkipLastTargetChannelWrapper for `skip_last_target`). The other losses of the
JAX registry raise until they are ported.
"""

import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.utils.misc import ITEM_LOSSES, get_logger, not_ported

logger = get_logger("Loss")

# losses of the JAX registry that the port does not have yet, with their ROADMAP item
_NOT_PORTED = {name: ITEM_LOSSES for name in (
    "CrossEntropyLoss", "WeightedCrossEntropyLoss", "GeneralizedDiceLoss", "MSELoss", "SmoothL1Loss", "L1Loss",
    "WeightedSmoothL1Loss")}


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

    if name in _NOT_PORTED:
        raise not_ported(f"loss {name}", _NOT_PORTED[name])
    if name == "BCEWithLogitsLoss":
        loss = BCEWithLogitsLoss(pos_weight=pos_weight)
    elif name == "BCEDiceLoss":
        loss = BCEDiceLoss(loss_config.get("alpha", 1.0))
    elif name == "DiceLoss":
        loss = DiceLoss(weight=weight, normalization=loss_config.get("normalization", "sigmoid"))
    else:
        raise RuntimeError(f"Unsupported loss function: '{name}'")

    if ignore_index is not None:
        loss = MaskingLossWrapper(loss, ignore_index)
    if skip_last_target:
        loss = SkipLastTargetChannelWrapper(loss, loss_config.get("squeeze_channel", False))
    return loss
