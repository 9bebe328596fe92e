"""The port's UNet3D (pytorch3dunet_tpu_torch/models) against the JAX package's
UNet3D with the same weights, crossed through `state_dict_from_jax`.

The JAX model takes its fused decoder where every level is an exact 2x and
the generic resize + concat decoder otherwise; the port makes the same choice
(models/blocks.py `Decoder.fused_mode`, at its default of
P3DUNET_FUSED_DECODER), so both shapes are held against it. Each path forced
on and off is in tests/test_torch_port_upconv.py.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu_torch.models.unet import UNet3D, get_model
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax

BASE = {"name": "UNet3D", "in_channels": 1, "f_maps": 8, "num_groups": 4, "num_levels": 3}


def _randomize(tree, rs):
    """Non-trivial norm affines and batch statistics (init leaves them 1/0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rs)
        elif k in ("scale", "var"):
            out[k] = (rs.rand(*v.shape) + 0.5).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (rs.rand(*v.shape) * 0.4 - 0.2).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _jax_model_and_variables(cfg, seed=0):
    model = jax_get_model(dict(cfg))
    variables = model.init(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return model, {k: _randomize(v, rs) for k, v in variables.items()}


@pytest.mark.parametrize("order,spatial,out_channels,final_sigmoid", [
    ("gcr", (16, 32, 32), 1, True),    # exact 2x at every level: the JAX fused decoder
    ("gcr", (12, 30, 34), 2, False),   # odd sizes: the JAX generic decoder
    ("bcr", (16, 32, 32), 2, False),
    ("bcr", (12, 30, 34), 1, True),
])
def test_forward_matches_jax(order, spatial, out_channels, final_sigmoid):
    cfg = {**BASE, "layer_order": order, "out_channels": out_channels, "final_sigmoid": final_sigmoid}
    jax_model, variables = _jax_model_and_variables(cfg)
    x = np.random.RandomState(5).rand(1, *spatial, 1).astype(np.float32)
    want_probs, want_logits = jax_model.apply(variables, x)

    model = get_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        probs, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want_logits), -1, 1), atol=2e-4)
    np.testing.assert_allclose(probs.numpy(), np.moveaxis(np.asarray(want_probs), -1, 1), atol=2e-4)


def test_regression_head_returns_logits_twice():
    cfg = {**BASE, "layer_order": "gcr", "out_channels": 1, "is_segmentation": False}
    jax_model, variables = _jax_model_and_variables(cfg, seed=1)
    x = np.random.RandomState(2).rand(1, 8, 16, 16, 1).astype(np.float32)
    _, want = jax_model.apply(variables, x)
    model = get_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        probs, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    assert probs is logits
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=2e-4)


@pytest.mark.parametrize("order", ["gcr", "bcr"])
def test_state_dict_round_trips(order):
    cfg = {**BASE, "layer_order": order, "out_channels": 2}
    torch.manual_seed(0)
    src = get_model(cfg)
    dst = get_model(cfg)
    dst.load_state_dict(src.state_dict(), strict=True)
    for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    # every key the JAX export writes is one of the port's, and back
    _, variables = _jax_model_and_variables(cfg)
    assert set(state_dict_from_jax(variables)) == set(src.state_dict())


def test_channel_schedule_of_the_confocal_model():
    model = UNet3D(in_channels=1, out_channels=1, f_maps=32, num_groups=8)
    convs = [(m.in_channels, m.out_channels) for m in model.modules()
             if isinstance(m, torch.nn.Conv3d) and m.kernel_size == (3, 3, 3)]
    assert convs == [(1, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256),
                     (384, 128), (128, 128), (192, 64), (64, 64), (96, 32), (32, 32)]
