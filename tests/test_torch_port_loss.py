"""The port's losses (pytorch3dunet_tpu_torch/losses.py, NCDHW) against the JAX
package's `get_loss_criterion` (channels-last): values, and gradients with
respect to the logits by `jax.grad`, on the same arrays, for every loss of the
registry. Cross-entropy targets are (N, D, H, W) class maps; the JAX side
moves the channel axis of the logits and of a target that has one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu_torch.losses import (CrossEntropyLoss, MaskingLossWrapper, SmoothL1Loss,
                                            WeightedCrossEntropyLoss, compute_per_channel_dice, flatten,
                                            get_loss_criterion)

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
    ({"name": "CrossEntropyLoss"}, 3),
    ({"name": "CrossEntropyLoss", "weight": [0.2, 1.0, 3.0]}, 3),
    ({"name": "CrossEntropyLoss", "ignore_index": -1}, 3),
    ({"name": "CrossEntropyLoss", "weight": [0.5, 2.0], "ignore_index": 1}, 2),
    ({"name": "CrossEntropyLoss", "skip_last_target": True, "squeeze_channel": True}, 3),
    ({"name": "WeightedCrossEntropyLoss"}, 3),
    ({"name": "WeightedCrossEntropyLoss", "weight": [0.2, 1.0, 3.0]}, 3),  # WCE ignores `weight`, as in JAX
    ({"name": "WeightedCrossEntropyLoss", "ignore_index": -1}, 3),
    ({"name": "WeightedCrossEntropyLoss", "ignore_index": 0}, 2),
    ({"name": "GeneralizedDiceLoss"}, 1),
    ({"name": "GeneralizedDiceLoss"}, 3),
    ({"name": "GeneralizedDiceLoss", "normalization": "softmax"}, 3),
    ({"name": "GeneralizedDiceLoss", "ignore_index": -1}, 2),
    ({"name": "SmoothL1Loss"}, 1),
    ({"name": "SmoothL1Loss", "ignore_index": None}, 2),
    ({"name": "SmoothL1Loss", "ignore_index": -1}, 1),
    ({"name": "WeightedSmoothL1Loss", "threshold": 0.0, "initial_weight": 3.0}, 1),
    ({"name": "WeightedSmoothL1Loss", "threshold": 0.0, "initial_weight": 3.0, "apply_below_threshold": False}, 2),
    ({"name": "MSELoss"}, 2),
    ({"name": "MSELoss", "ignore_index": -1}, 2),
    ({"name": "L1Loss"}, 1),
    ({"name": "L1Loss", "skip_last_target": True}, 1),
]
CLASS_MAP_LOSSES = {"CrossEntropyLoss", "WeightedCrossEntropyLoss"}
REGRESSION_LOSSES = {"SmoothL1Loss", "WeightedSmoothL1Loss", "MSELoss", "L1Loss"}


def _arrays(loss_config, channels, seed):
    """NCDHW logits and targets: a binary NCDHW target, a float one for the
    regression losses, or an int64 (N, D, H, W) class map for the
    cross-entropies. One target channel more under skip_last_target (a label
    channel; a class map then gets a channel axis), and voxels set to
    ignore_index where there is one."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(2, channels, *SPATIAL).astype(np.float32)
    name, skip = loss_config["name"], loss_config.get("skip_last_target")
    if name in CLASS_MAP_LOSSES:
        target = rs.randint(0, channels, (2, *SPATIAL))
        if skip:
            target = np.stack([target, rs.randint(0, 5, target.shape)], axis=1)
    else:
        shape = (2, channels + (1 if skip else 0), *SPATIAL)
        target = (rs.randn(*shape) if name in REGRESSION_LOSSES else rs.rand(*shape) > 0.5).astype(np.float32)
        if skip:
            target[:, -1] = rs.randint(0, 5, (2, *SPATIAL))
    if loss_config.get("ignore_index") is not None:
        target[rs.rand(*target.shape) < 0.2] = loss_config["ignore_index"]
    return logits, target


def _jax_value_and_grad(loss_config, logits, target):
    criterion = jax_get_loss_criterion({"loss": dict(loss_config)})
    jax_target = jnp.asarray(np.moveaxis(target, 1, -1) if target.ndim == logits.ndim else target)
    loss, grad = jax.value_and_grad(lambda x: criterion(x, jax_target))(jnp.asarray(np.moveaxis(logits, 1, -1)))
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


@pytest.mark.parametrize("name", ["CrossEntropyLoss", "WeightedCrossEntropyLoss"])
def test_cross_entropy_of_an_all_ignored_batch_is_zero_as_in_jax(name):
    # the weighted sum over no counted voxel, divided by a clamped weight sum:
    # 0 with a zero gradient, where F.cross_entropy(reduction="mean") gives NaN
    loss_config = {"name": name, "ignore_index": -1}
    logits, _ = _arrays(loss_config, 3, seed=5)
    target = np.full((2, *SPATIAL), -1, dtype=np.int64)
    want_loss, want_grad = _jax_value_and_grad(loss_config, logits, target)
    x = torch.from_numpy(logits).requires_grad_()
    loss = get_loss_criterion({"loss": loss_config})(x, torch.from_numpy(target))
    loss.backward()
    assert want_loss == 0.0 and loss.item() == 0.0
    np.testing.assert_array_equal(x.grad.numpy(), want_grad)
    assert not x.grad.abs().sum()


def test_cross_entropies_take_ignore_index_themselves_and_the_rest_are_masked():
    for name, cls in (("CrossEntropyLoss", CrossEntropyLoss), ("WeightedCrossEntropyLoss", WeightedCrossEntropyLoss)):
        loss = get_loss_criterion({"loss": {"name": name, "ignore_index": 2}})
        assert type(loss) is cls and loss.ignore_index == 2
    masked = get_loss_criterion({"loss": {"name": "SmoothL1Loss", "ignore_index": -1}})
    assert isinstance(masked, MaskingLossWrapper) and masked.ignore_index == -1
    # the denoising configs set `ignore_index: null`: no wrapper
    assert type(get_loss_criterion({"loss": {"name": "SmoothL1Loss", "ignore_index": None}})) is SmoothL1Loss


def test_cross_entropies_default_to_ignore_index_minus_100_through_a_config():
    # WCE's own default of -1 applies only when the class is built directly
    for name in ("CrossEntropyLoss", "WeightedCrossEntropyLoss"):
        assert get_loss_criterion({"loss": {"name": name}}).ignore_index == -100
    assert WeightedCrossEntropyLoss().ignore_index == -1 and CrossEntropyLoss().ignore_index == -100


def test_unknown_loss_raises():
    with pytest.raises(RuntimeError, match="Unsupported loss"):
        get_loss_criterion({"loss": {"name": "FocalLoss"}})
