"""The model options beside the default ones, against the JAX package on the
CPU: every upsample mode in 2D and 3D, `conv_kernel_size`, `conv_padding`
(ints and per-axis tuples) and `conv_upscale`, `pool_kernel_size` tuples, with
the same weights crossed through `state_dict_from_jax`; `Conv3d`'s shape
dispatch between the kernels' `Conv3dFunction` and `F.conv3d`.

`upsample: area` is the one mode held to torch rather than to JAX (ROADMAP
F3): JAX maps it to `jax.image.resize(..., 'linear', antialias=True)`, and
antialiasing changes nothing when upsampling, so the JAX decoder resizes
linearly; torch's 'area' is adaptive average pooling, which upsamples by
repeating. With the same weights, `AREA_CFG` on a 30 x 34 input gives logits
up to 0.591 apart in the two packages (measured on the CPU when this test was
written; the test asserts torch's definition only).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu_torch.models import blocks
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d, kernel_conv_plan
from pytorch3dunet_tpu_torch.ops import conv3d
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax
from pytorch3dunet_tpu.models import get_model as jax_get_model
from tests.test_torch_port_model import _randomize

TOL = 2e-4
BASE = {"in_channels": 1, "out_channels": 2, "f_maps": 4, "num_groups": 2, "num_levels": 2, "final_sigmoid": False,
        "layer_order": "gcr"}
# odd sizes: the decoder's resize is not an exact 2x
SPATIAL = {True: (5, 14, 18), False: (14, 18)}


def _forward_both(cfg, spatial=None, seed=0):
    """Logits of the JAX model and of the port's with its weights, both NC...
    (init and apply jitted: eager flax dispatches op by op)."""
    jax_model = jax_get_model(dict(cfg))
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    variables = {k: _randomize(v, rs) for k, v in variables.items()}
    model = get_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    spatial = spatial or SPATIAL[not is_model_2d(model)]
    x = np.random.RandomState(seed + 5).rand(2, *spatial, cfg["in_channels"]).astype(np.float32)
    _, want = jax.jit(lambda v, xi: jax_model.apply(v, xi))(variables, x)
    with torch.inference_mode():
        _, got = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    return got.numpy(), np.moveaxis(np.asarray(want), -1, 1)


@pytest.mark.parametrize("name,upsample", [
    ("UNet2D", "nearest"), ("UNet2D", "linear"), ("UNet2D", "bilinear"),
    ("UNet2D", "trilinear"),  # torch refuses 'trilinear' on a 4-D tensor; JAX resizes linearly
    ("UNet2D", "deconv"), ("ResidualUNet2D", "nearest"),
    ("UNet3D", "bilinear"), ("UNet3D", "deconv"), ("ResidualUNet3D", "trilinear"),
])
def test_upsample_mode_matches_jax(name, upsample):
    got, want = _forward_both({**BASE, "name": name, "upsample": upsample})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name,spatial,upsample", [("UNet2D", (12, 12), None), ("UNet2D", (12, 12), "none"),
                                                  ("UNet3D", (4, 12, 12), "none")])
def test_no_upsampling_matches_jax(name, spatial, upsample):
    # without a resize x must have the skip's size: pooling windows of 1
    got, want = _forward_both({**BASE, "name": name, "upsample": upsample, "pool_kernel_size": 1}, spatial)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


AREA_CFG = {**BASE, "name": "UNet2D", "upsample": "area"}


def test_area_is_torchs_adaptive_average_pooling(monkeypatch):
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 4, 7, 9).astype(np.float32))
    for size in ((14, 18), (15, 20)):
        torch.testing.assert_close(blocks.resize(x, size, "area"), F.adaptive_avg_pool2d(x, size), rtol=0, atol=0)
    # at exact 2x every level, 'area' repeats each voxel: the nearest model's
    # output on the generic decoder (the same ops; the fused one sums in another order)
    monkeypatch.setenv("P3DUNET_FUSED_DECODER", "0")
    area, nearest = get_model(AREA_CFG).eval(), get_model({**AREA_CFG, "upsample": "nearest"}).eval()
    nearest.load_state_dict(area.state_dict())
    xs = torch.rand(1, 1, 16, 16)
    with torch.inference_mode():
        torch.testing.assert_close(area(xs)[1], nearest(xs)[1], rtol=0, atol=0)


@pytest.mark.parametrize("name,options", [
    ("UNet3D", {"conv_kernel_size": [1, 3, 3], "conv_padding": [0, 1, 1]}),
    ("UNet3D", {"conv_kernel_size": (3, 3, 3), "conv_padding": (1, 1, 1), "pool_kernel_size": [1, 2, 2],
                "conv_upscale": 1}),
    ("UNet3D", {"conv_kernel_size": [1, 3, 3], "conv_padding": [0, 1, 1], "upsample": "deconv"}),
    ("ResidualUNet3D", {"conv_kernel_size": [1, 3, 3], "pool_kernel_size": [1, 2, 2]}),
    ("UNet2D", {"conv_kernel_size": 5, "conv_padding": 2}),
    ("UNet2D", {"conv_kernel_size": [3, 5], "conv_padding": [1, 2], "upsample": "deconv"}),
    ("UNet2D", {"conv_upscale": 1, "layer_order": "bcr"}),
    ("ResidualUNet2D", {"conv_kernel_size": 5}),
    ("ResidualUNet2D", {"conv_kernel_size": [1, 3]}),  # a 1-tap transposed conv: the zero border of flax's padding
])
def test_conv_options_match_jax(name, options):
    got, want = _forward_both({**BASE, "name": name, **options})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_conv_upscale_1_widens_the_first_encoder_conv():
    convs = [(m.in_channels, m.out_channels) for m in get_model({**BASE, "name": "UNet3D", "conv_upscale": 1,
                                                                  "f_maps": 8}).modules()
             if isinstance(m, conv3d.Conv3d) and m.on_kernels]
    # encoder conv1 -> out_channels (8, 16), not out_channels // 2, floored at in_channels
    assert convs[:4] == [(1, 8), (8, 8), (8, 16), (16, 16)]


@pytest.mark.parametrize("options,on_kernels", [({}, 10), ({"conv_kernel_size": [1, 3, 3],
                                                            "conv_padding": [0, 1, 1]}, 0)])
def test_conv3d_dispatch_follows_the_shape(monkeypatch, options, on_kernels):
    """3x3x3 pad 1 goes through `Conv3dFunction` (K2 forward, K3 input grad on
    CUDA), every other conv through `F.conv3d`: counted in a train step."""
    model = get_model({**BASE, "name": "UNet3D", "num_levels": 3, **options}).train()
    convs = [m for m in model.modules() if isinstance(m, conv3d.Conv3d)]
    assert sum(m.on_kernels for m in convs) == on_kernels
    calls = {"function": 0, "torch": 0}
    apply, conv = conv3d.Conv3dFunction.apply, F.conv3d

    def count(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(conv3d.Conv3dFunction, "apply", count("function", apply))
    monkeypatch.setattr(conv3d.F, "conv3d", count("torch", conv))
    logits = model(torch.rand(1, 1, 8, 16, 16))[1]
    # on the CPU the kernels' plain forward is one F.conv3d each; a fused
    # decoder's first conv is two kernel convs (`kernel_conv_plan`)
    on_path = len(kernel_conv_plan(model, (8, 16, 16)))
    assert calls == {"function": on_path, "torch": on_path + len(convs) - on_kernels}
    logits.sum().backward()
    assert all(m.weight.grad is not None for m in convs)


def test_unknown_upsample_mode_is_refused():
    with pytest.raises(ValueError, match="upsample mode"):
        get_model({**BASE, "name": "UNet2D", "upsample": "cubic"})
