"""`model.dtype: bfloat16` in the port against the JAX package.

The bf16 forward follows the JAX semantics: the input is cast to bf16, the
parameters stay float32 and are cast where they are used, the norms compute in
float32, the logits come back in float32.

The two bf16 forwards round the conv in different places. The JAX model
computes each 3x3x3 conv as three 2D convs whose bf16 outputs are summed in
bf16, then adds the bias in bf16 (pytorch3dunet_tpu/ops/conv.py `_as2d`): four
roundings. The port's conv (the kernels' contract, and their plain version on
the CPU) accumulates all 27 taps in float32 and rounds once. Each is a bf16
approximation of the same float32 function, and at these widths either one is
up to 2.1e-2 from the float32 forward, so two tests hold the port:
- with its plain conv rounded as the JAX conv (`jax_conv_rounding`, a
  test-side emulation), its bf16 forward against the JAX bf16 forward, within
  2e-2: every other cast, norm and layer in bf16 as the JAX package does it;
- as it is, its bf16 forward against the float32 forward, within twice the JAX
  bf16 forward's own distance from it.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu_torch.models.unet import compute_dtype, get_model
from pytorch3dunet_tpu_torch.ops import conv3d
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax

# max |port - JAX| of the bf16 probabilities
BF16_TOL = 2e-2


def _perturbed_norms(variables, seed=1):
    """Norm affines away from their init (scale 1, bias 0)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rs.rand(*v.shape).astype(np.float32) + 0.5) if path[-1].key == "scale"
        else (rs.rand(*v.shape).astype(np.float32) * 0.4 - 0.2) if path[-1].key == "bias" else np.asarray(v),
        variables)


@pytest.mark.parametrize("value,expected", [(None, None), ("float32", None), ("fp32", None),
                                            ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16)])
def test_dtype_values_of_the_jax_get_model(value, expected):
    assert compute_dtype(value) == expected
    model = get_model({"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 8, "num_levels": 2,
                       "dtype": value})
    assert model.compute_dtype == expected
    # the parameters stay float32 whatever the compute dtype
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_unknown_dtype_raises():
    with pytest.raises(ValueError, match="model.dtype"):
        get_model({"name": "UNet3D", "in_channels": 1, "out_channels": 1, "dtype": "float16"})


@pytest.fixture
def jax_conv_rounding(monkeypatch):
    """The port's plain conv in bf16 rounded as the JAX model's `_as2d`: one
    2D conv (float32 sums, bf16 output) per depth tap, the three summed in
    bf16, the bias added in bf16."""
    plain = conv3d.conv3d_fwd_reference

    def as2d(x, w, b=None):
        if x.dtype != torch.bfloat16:
            return plain(x, w, b)
        xp = F.pad(x.permute(0, 4, 1, 2, 3).float(), (0, 0, 0, 0, 1, 1))
        w = w.to(x.dtype).float()
        out = None
        for dz in range(3):
            tap = F.conv3d(xp[:, :, dz : dz + x.shape[1]], w[dz : dz + 1].permute(4, 3, 0, 1, 2), padding=(0, 1, 1))
            out = tap.to(x.dtype) if out is None else out + tap.to(x.dtype)
        if b is not None:
            out = out + b.to(x.dtype)[None, :, None, None, None]
        return out.permute(0, 2, 3, 4, 1).contiguous()

    monkeypatch.setattr(conv3d, "conv3d_fwd_reference", as2d)


@functools.cache
def _forwards(name):
    """(port bf16 model, input, JAX bf16 probabilities, JAX f32 probabilities)
    of one seeded model and input, channels-last numpy; both tests read them."""
    cfg = {"name": name, "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8, "num_groups": 4,
           "num_levels": 3, "final_sigmoid": False}
    variables = _perturbed_norms(jax_get_model(dict(cfg)).init(jax.random.PRNGKey(0)))
    x = np.random.RandomState(0).randn(1, 16, 64, 64, 1).astype(np.float32)
    want = {}
    for dtype in ("bfloat16", None):
        jax_model = jax_get_model({**cfg, "dtype": dtype})
        want[dtype] = np.asarray(jax.jit(lambda v, x: jax_model.apply(v, x))(variables, x)[0])
    model = get_model({**cfg, "dtype": "bfloat16"})
    model.load_state_dict(state_dict_from_jax(variables))
    return model.eval(), torch.from_numpy(np.moveaxis(x, -1, 1)), want["bfloat16"], want[None]


def _probs(model, x):
    with torch.inference_mode():
        probs, logits = model(x)
    assert probs.dtype == logits.dtype == torch.float32
    got = np.moveaxis(probs.numpy(), 1, -1)
    assert np.isfinite(got).all()
    return got


# measured max |port - JAX| of the probabilities (CPU, this seed and input),
# with the conv rounded alike: UNet3D 8.79e-3, ResidualUNet3D 8.64e-3,
# ResidualUNetSE3D 4.63e-3 (without: 2.109e-2, 7.94e-3, 4.77e-3)
@pytest.mark.parametrize("name", ["UNet3D", "ResidualUNet3D", "ResidualUNetSE3D"])
def test_bf16_forward_matches_jax(name, jax_conv_rounding):
    model, x, want, _ = _forwards(name)
    np.testing.assert_allclose(_probs(model, x), want, atol=BF16_TOL)


# measured max |bf16 - f32| of the probabilities (CPU, this seed and input),
# port / JAX: UNet3D 2.074e-2 / 2.062e-2, ResidualUNet3D 7.51e-3 / 6.67e-3,
# ResidualUNetSE3D 3.49e-3 / 4.40e-3
@pytest.mark.parametrize("name", ["UNet3D", "ResidualUNet3D", "ResidualUNetSE3D"])
def test_bf16_forward_is_within_twice_the_jax_bf16_error(name):
    model, x, want_bf16, want_f32 = _forwards(name)
    jax_error = np.abs(want_bf16 - want_f32).max()
    assert np.abs(_probs(model, x) - want_f32).max() <= 2 * jax_error


def test_bf16_layers_compute_in_bf16_with_f32_norms():
    model = get_model({"name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 1, "f_maps": 8,
                       "num_groups": 4, "num_levels": 2, "dtype": "bf16"}).eval()
    seen = {}

    def record(module, inputs, output):
        seen[type(module).__name__] = (inputs[0].dtype, output.dtype)

    for module in model.modules():
        if type(module).__name__ in ("Conv3d", "GroupNorm", "ChannelSELayer3D", "SpatialSELayer3D", "Upsample"):
            module.register_forward_hook(record)
    with torch.inference_mode():
        model(torch.randn(1, 1, 8, 16, 16))
    assert seen == {name: (torch.bfloat16, torch.bfloat16) for name in
                    ("Conv3d", "GroupNorm", "ChannelSELayer3D", "SpatialSELayer3D", "Upsample")}

