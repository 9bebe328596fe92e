"""BCEDiceLoss on logits, as pytorch-3dunet defines it: the mean binary
cross-entropy plus `alpha` times 1 - the mean over channels of the Dice
coefficient of the sigmoid (V-Net squared denominator, clamped at 1e-6)."""

import torch
import torch.nn.functional as F


def make(alpha: float = 1.0):
    def loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        target = target.to(logits.dtype)
        bce = F.binary_cross_entropy_with_logits(logits, target)
        probs = torch.sigmoid(logits)
        p = probs.transpose(0, 1).reshape(probs.shape[1], -1)
        t = target.transpose(0, 1).reshape(target.shape[1], -1)
        dice = 2 * (p * t).sum(-1) / ((p * p).sum(-1) + (t * t).sum(-1)).clamp(min=1e-6)
        return bce + alpha * (1.0 - dice.mean())

    return loss
