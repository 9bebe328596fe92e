"""Optimizer and lr-scheduler factories of the port: the torch natives, built
from the JAX package's config schema (pytorch3dunet_tpu/utils/optim.py).

`Adam` (the default) is `torch.optim.Adam`, whose weight decay adds wd * p to
the gradient before the moments, as the JAX package's `_with_l2` does. `SGD`
is there as the exact oracle of the trajectory tests. The scheduler is
`ReduceLROnPlateau` with the JAX class's arguments and defaults. Every other
name raises until it is ported.
"""

import torch

from pytorch3dunet_tpu_torch.utils.misc import ITEM_TRAINER, get_logger, not_ported

logger = get_logger("Optim")

# the JAX package's other optimizer and scheduler names
_NOT_PORTED_OPTIMIZERS = ("Adadelta", "Adagrad", "AdamW", "SparseAdam", "Adamax", "LBFGS", "NAdam", "RAdam",
                          "RMSprop", "Rprop")
_NOT_PORTED_SCHEDULERS = ("MultiStepLR", "StepLR", "ExponentialLR", "CosineAnnealingLR",
                          "CosineAnnealingWarmRestarts", "ConstantLR", "LinearLR", "PolynomialLR", "OneCycleLR",
                          "LambdaLR")


def create_optimizer(optimizer_config: dict, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Builds the optimizer of `model`'s parameters from config['optimizer']."""
    name = optimizer_config.get("name", "Adam")
    learning_rate = optimizer_config.get("learning_rate", 1e-3)
    weight_decay = optimizer_config.get("weight_decay", 0)
    if name in _NOT_PORTED_OPTIMIZERS:
        raise not_ported(f"optimizer {name}", ITEM_TRAINER)
    if optimizer_config.get("mu_dtype") is not None:
        raise not_ported("optimizer.mu_dtype", ITEM_TRAINER)
    if name == "Adam":
        betas = tuple(optimizer_config.get("betas", (0.9, 0.999)))
        return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=betas, weight_decay=weight_decay)
    if name == "SGD":
        return torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=optimizer_config.get("momentum", 0),
                               nesterov=optimizer_config.get("nesterov", False), weight_decay=weight_decay)
    raise RuntimeError(f"Unsupported optimizer: '{name}'")


def create_lr_scheduler(lr_config: dict | None, optimizer: torch.optim.Optimizer):
    """Builds the scheduler named by config['lr_scheduler'], or None."""
    if lr_config is None:
        return None
    lr_config = dict(lr_config)
    name = lr_config.pop("name")
    if name in _NOT_PORTED_SCHEDULERS:
        raise not_ported(f"lr scheduler {name}", ITEM_TRAINER)
    if name != "ReduceLROnPlateau":
        raise RuntimeError(f"Unsupported lr scheduler: '{name}'")
    # the JAX class's arguments and defaults (torch's are the same)
    defaults = {"mode": "min", "factor": 0.1, "patience": 10, "threshold": 1e-4, "threshold_mode": "rel",
                "cooldown": 0, "min_lr": 0.0, "eps": 1e-8}
    ignored = sorted(set(lr_config) - set(defaults))
    if ignored:
        # the JAX class swallows other keys too
        logger.warning(f"ReduceLROnPlateau ignores the config keys {ignored}")
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, **{key: lr_config.get(key, value) for key, value in defaults.items()})
