"""The port's losses (pytorch3dunet_tpu_torch/losses.py, NCDHW) against the JAX
package's `get_loss_criterion` (channels-last): values, and gradients with
respect to the logits by `jax.grad`, on the same arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu_torch.losses import compute_per_channel_dice, flatten, get_loss_criterion

SPATIAL = (4, 6, 5)
CASES = [
    ({"name": "BCEDiceLoss"}, 2),
    ({"name": "BCEDiceLoss", "alpha": 0.5}, 1),
    ({"name": "BCEDiceLoss", "skip_last_target": True}, 1),
    ({"name": "BCEDiceLoss", "ignore_index": -1, "skip_last_target": True}, 1),
    ({"name": "DiceLoss"}, 2),
    ({"name": "DiceLoss", "normalization": "softmax", "weight": [0.3, 0.7]}, 2),
    ({"name": "DiceLoss", "ignore_index": -1}, 2),
    ({"name": "DiceLoss", "skip_last_target": True, "normalization": "none"}, 1),
    ({"name": "BCEWithLogitsLoss"}, 2),
    ({"name": "BCEWithLogitsLoss", "pos_weight": [2.0, 0.5]}, 2),
    ({"name": "BCEWithLogitsLoss", "ignore_index": -1}, 2),
    ({"name": "BCEWithLogitsLoss", "skip_last_target": True}, 3),
]


def _arrays(loss_config, channels, seed):
    """NCDHW logits and targets; one target channel more under skip_last_target
    (a label channel), and voxels set to ignore_index where there is one."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, channels, *SPATIAL).astype(np.float32)
    target_channels = channels + (1 if loss_config.get("skip_last_target") else 0)
    target = (rs.rand(2, target_channels, *SPATIAL) > 0.5).astype(np.float32)
    if loss_config.get("skip_last_target"):
        target[:, -1] = rs.randint(0, 5, (2, *SPATIAL))
    if "ignore_index" in loss_config:
        target[rs.rand(*target.shape) < 0.2] = loss_config["ignore_index"]
    return logits, target


def _jax_value_and_grad(loss_config, logits, target):
    criterion = jax_get_loss_criterion({"loss": dict(loss_config)})
    loss, grad = jax.value_and_grad(lambda x: criterion(x, jnp.asarray(np.moveaxis(target, 1, -1))))(
        jnp.asarray(np.moveaxis(logits, 1, -1)))
    return float(loss), np.moveaxis(np.asarray(grad), -1, 1)


@pytest.mark.parametrize("loss_config,channels", CASES)
def test_loss_and_logit_grads_match_jax(loss_config, channels):
    logits, target = _arrays(loss_config, channels, seed=channels)
    want_loss, want_grad = _jax_value_and_grad(loss_config, logits, target)

    x = torch.from_numpy(logits).requires_grad_()
    loss = get_loss_criterion({"loss": dict(loss_config)})(x, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0, atol=1e-5)


def test_confocal_recipe_loss_on_a_boundary_target():
    # BCEDiceLoss with skip_last_target on the (boundary, label) target of
    # StandardLabelToBoundary(append_label=True), as the confocal recipe trains
    from pytorch3dunet_tpu.augment.transforms import StandardLabelToBoundary

    rs = np.random.RandomState(3)
    label = np.repeat(np.repeat(rs.randint(1, 6, (4, 3, 3)), 3, axis=1), 3, axis=2)
    target = StandardLabelToBoundary(append_label=True)(label).astype(np.float32)[None]
    logits = rs.randn(1, 1, *label.shape).astype(np.float32)
    config = {"name": "BCEDiceLoss", "ignore_index": None, "skip_last_target": True}
    want_loss, want_grad = _jax_value_and_grad(config, logits, target)
    x = torch.from_numpy(logits).requires_grad_()
    loss = get_loss_criterion({"loss": config})(x, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0, atol=1e-5)


def test_flatten_and_dice_are_per_channel():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    assert flatten(x).shape == (3, 8)
    np.testing.assert_array_equal(flatten(x)[1].numpy(), [4, 5, 6, 7, 16, 17, 18, 19])
    dice = compute_per_channel_dice(torch.ones(1, 2, 3), torch.ones(1, 2, 3))
    np.testing.assert_allclose(dice.numpy(), [1.0, 1.0])


@pytest.mark.parametrize("name", ["CrossEntropyLoss", "GeneralizedDiceLoss", "MSELoss", "WeightedSmoothL1Loss"])
def test_unported_losses_raise(name):
    with pytest.raises(NotImplementedError, match="The rest of the losses and metrics"):
        get_loss_criterion({"loss": {"name": name}})


def test_unknown_loss_raises():
    with pytest.raises(RuntimeError, match="Unsupported loss"):
        get_loss_criterion({"loss": {"name": "FocalLoss"}})
