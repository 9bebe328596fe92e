"""The port's decoder formulations (pytorch3dunet_tpu_torch/ops/upconv.py, and
the fused decoder and phase deconv of models/blocks.py) against the JAX
package's (pytorch3dunet_tpu/ops/upconv.py, models/blocks.py) on the CPU,
where the port's K2/K3 calls run their plain versions.

The same numpy inputs, made from a seed, go through each JAX function and its
port counterpart. Tolerances: the weight algebra within 1e-6 of the largest
value (sums of two to eight f32 taps); the convs, statistics and fused joins
within 1e-5 of the largest value (f32 sums in another order); in bf16 the
port's plain conv is rounded as the JAX conv (`jax_conv_rounding` of
tests/test_torch_port_bf16.py), and the two still round the collapsed bf16
kernel taps and the norm's apply apart, so the bf16 joins are held within
2e-2 of the largest value (the bf16 model tests' bound). Whole models at the
JAX package's defaults (fused decoder, phase deconv) against the port with
each path forced, within 2e-4 (tests/test_torch_port_model.py's bound), and
one step's gradients within 1e-4 of each tensor's own max|g|.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu.models import blocks as jax_blocks
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.ops import upconv as jax_upconv
from pytorch3dunet_tpu_torch.export import export_model, load_exported
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models import blocks
from pytorch3dunet_tpu_torch.models.unet import get_model, kernel_conv_plan
from pytorch3dunet_tpu_torch.ops import conv3d, upconv
from pytorch3dunet_tpu_torch.parallel.mesh import Mesh, data_axis
from pytorch3dunet_tpu_torch.parallel.spatial import spatial_axis
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_bf16 import jax_conv_rounding  # noqa: F401 (a fixture)
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_resunet import BASE as RES_BASE
from tests.test_torch_port_resunet import _input, _target
from tests.test_torch_port_train import LOSS, _batches

WEIGHT_TOL, TOL, BF16_TOL, MODEL_TOL, GRAD_TOL = 1e-6, 1e-5, 2e-2, 2e-4, 1e-4
SWITCHES = ("P3DUNET_FUSED_DECODER", "P3DUNET_FUSED_DECODER_MIXED", "P3DUNET_DECONV", "P3DUNET_UPCONV",
            "P3DUNET_SKIPCONV", "P3DUNET_GN_APPLY", "P3DUNET_TAPFOLD")


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    """Every switch at its default unless a test sets it; both packages read
    them at call time."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _jit(fn, **static):
    """fn under a jit of its own (a new cache: the switches are read while it
    traces), `static` and the int keywords bound as they are."""
    def call(*args, **kwargs):
        ints = {k: v for k, v in kwargs.items() if isinstance(v, int)}
        arrays = {k: v for k, v in kwargs.items() if k not in ints}
        return jax.jit(lambda *a, **kw: fn(*a, **kw, **ints, **static))(*args, **arrays)
    return call


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, want, tol):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (list, tuple)) else list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.detach().float().numpy(), np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-30))


# --- the weight algebra and the layouts -----------------------------------------------------------------------


WEIGHT_FNS = {  # name -> spatial rank of its kernel
    "collapse_phase_kernels": 3, "_phase_embed": 3, "embed_wide_kernel": 3, "embed_wide_kernel_d": 3,
    "collapse_deconv_kernels": 3, "collapse_phase_kernels_2d": 2, "embed_wide_kernel_2d": 2,
}


@pytest.mark.parametrize("name", sorted(WEIGHT_FNS))
def test_weight_algebra_matches_jax(name):
    """Values, and the gradient of a random projection back to the one kernel
    (the weight gradient of every fused conv flows through these ops)."""
    rs = np.random.RandomState(0)
    kernel = _rand(rs, *(3,) * WEIGHT_FNS[name], 5, 4)
    want = _jit(getattr(jax_upconv, name))(jnp.asarray(kernel))
    k = _t(kernel).requires_grad_()
    got = getattr(upconv, name)(k)
    _close(got, want, WEIGHT_TOL)
    probes = [_rand(rs, *np.shape(w)) for w in (want if isinstance(want, list) else [want])]

    def project(outs, xp):
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        return sum((o * xp.asarray(p)).sum() for o, p in zip(outs, probes))

    want_grad = _jit(jax.grad(lambda kk: project(getattr(jax_upconv, name)(kk), jnp)))(jnp.asarray(kernel))
    project(got, torch).backward()
    _close(k.grad, want_grad, WEIGHT_TOL)


@pytest.mark.parametrize("name,shape,blocks", [
    ("depth_to_space_blocks", (2, 2, 3, 4, 8 * 3), 3),
    ("depth_to_space_blocks_d", (2, 2, 3, 4, 2 * 3), 3),
    ("space_interleave_2d", (2, 3, 4, 4 * 3), 3),
])
def test_layouts_match_jax(name, shape, blocks):
    x = _rand(np.random.RandomState(1), *shape)
    _close(getattr(upconv, name)(_t(x), blocks), getattr(jax_upconv, name)(jnp.asarray(x), blocks), 0)


# --- the convs ------------------------------------------------------------------------------------------------


CONVS = {  # case -> (function, x shape, kernel shape, P3DUNET_UPCONV)
    "wide_blocks": ("_upconv_wide_blocks", (2, 3, 4, 5, 6), (3, 3, 3, 6, 4), None),
    "wide_blocks_d": ("_upconv_wide_blocks_d", (1, 3, 8, 9, 6), (3, 3, 3, 6, 4), None),
    "upsampled_wide": ("phase_conv_upsampled", (2, 3, 4, 5, 6), (3, 3, 3, 6, 4), "wide"),
    "upsampled_phase": ("phase_conv_upsampled", (2, 3, 4, 5, 6), (3, 3, 3, 6, 4), "phase"),
    "strided_blocks": ("strided_conv_blocks", (1, 6, 8, 10, 5), (3, 3, 3, 5, 4), None),
    "conv_transpose": ("phase_conv_transpose", (1, 3, 5, 4, 6), (3, 3, 3, 6, 4), None),
    "upsampled_2d": ("phase_conv_upsampled_2d", (2, 5, 6, 6), (3, 3, 6, 4), None),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_convs_match_jax(case, monkeypatch):
    name, x_shape, k_shape, mode = CONVS[case]
    if mode:
        monkeypatch.setenv("P3DUNET_UPCONV", mode)
    rs = np.random.RandomState(2)
    x, kernel = _rand(rs, *x_shape), _rand(rs, *k_shape) / 10
    want = _jit(getattr(jax_upconv, name))(jnp.asarray(x), jnp.asarray(kernel))
    _close(getattr(upconv, name)(_t(x), _t(kernel)), want, TOL)


@pytest.mark.parametrize("spatial", [(3, 5, 4), (1, 2, 7)])
def test_phase_conv_transpose_is_the_transposed_conv(spatial):
    """Against torch's ConvTranspose3d (kernel 3, stride 2, padding 1) with the
    torch weight, whose flip is the flax kernel, and against JAX's: 2n - 1 a side."""
    rs = np.random.RandomState(3)
    x, weight = _rand(rs, 2, 6, *spatial), _rand(rs, 6, 4, 3, 3, 3)
    want = F.conv_transpose3d(_t(x), _t(weight), stride=2, padding=1)
    kernel = _t(weight).flip(2, 3, 4).permute(2, 3, 4, 0, 1)
    got = upconv.phase_conv_transpose(_t(x).movedim(1, -1), kernel)
    assert got.shape[1:4] == tuple(2 * n - 1 for n in spatial)
    _close(got.movedim(-1, 1), want.numpy(), TOL)
    _close(got, jax_upconv.phase_conv_transpose(jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(kernel.numpy())),
           TOL)


# --- the statistics and the affine ----------------------------------------------------------------------------


STATS = {  # case -> (skip shape, xs shape, replication factor)
    "full": ((2, 4, 6, 8, 6), (2, 2, 3, 4, 10), 8.0),
    "depth_only": ((2, 4, 6, 8, 6), (2, 2, 6, 8, 10), 2.0),
    "2d": ((2, 6, 8, 6), (2, 3, 4, 10), 4.0),
}


def _upsampled(xs, skip_shape):
    """Nearest up of channels-last xs to skip's spatial shape."""
    up = F.interpolate(_t(xs).movedim(-1, 1), size=skip_shape[1:-1], mode="nearest")
    return up.movedim(1, -1)


@pytest.mark.parametrize("case", sorted(STATS))
def test_concat_group_stats_match_jax_and_groupnorm(case):
    skip_shape, xs_shape, factor = STATS[case]
    rs = np.random.RandomState(4)
    skip, xs = _rand(rs, *skip_shape) + 0.3, _rand(rs, *xs_shape) * 2 - 0.1
    mean_c, inv_c = upconv.concat_group_stats(_t(skip), _t(xs), 4, factor=factor)
    _close((mean_c, inv_c), jax_upconv.concat_group_stats(jnp.asarray(skip), jnp.asarray(xs), 4, factor=factor),
           TOL)
    # the statistics of the materialized concat, as GroupNorm normalizes it
    concat = torch.cat([_t(skip), _upsampled(xs, skip_shape)], -1)
    normed = F.group_norm(concat.movedim(-1, 1), 4, eps=1e-5).movedim(1, -1)
    bshape = (skip_shape[0],) + (1,) * (len(skip_shape) - 2) + (-1,)
    _close((concat - mean_c.reshape(bshape)) * inv_c.reshape(bshape), normed.numpy(), TOL)


@pytest.mark.parametrize("case", ["full", "2d"])
def test_concat_batch_stats_match_jax_and_the_concat(case):
    skip_shape, xs_shape, _ = STATS[case]
    rs = np.random.RandomState(5)
    skip, xs = _rand(rs, *skip_shape) + 0.3, _rand(rs, *xs_shape) * 2 - 0.1
    mean, var = upconv.concat_batch_stats(_t(skip), _t(xs))
    _close((mean, var), jax_upconv.concat_batch_stats(jnp.asarray(skip), jnp.asarray(xs)), TOL)
    concat = torch.cat([_t(skip), _upsampled(xs, skip_shape)], -1).flatten(0, -2)
    _close((mean, var), (concat.mean(0).numpy(), concat.var(0, unbiased=False).numpy()), TOL)


@pytest.mark.parametrize("dtype,apply", [("float32", "f32"), ("bfloat16", "f32"), ("bfloat16", "compute")])
@pytest.mark.parametrize("per_sample", [True, False], ids=["groupnorm", "batchnorm"])
def test_apply_norm_affine_matches_jax(dtype, apply, per_sample, monkeypatch):
    monkeypatch.setenv("P3DUNET_GN_APPLY", apply)
    rs = np.random.RandomState(6)
    skip, xs = _rand(rs, 2, 4, 6, 8, 3), _rand(rs, 2, 2, 3, 4, 5)
    affine = [_rand(rs, *((2, 8) if per_sample else (8,))) for _ in range(2)]
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    got = upconv._apply_norm_affine(_t(skip).to(tdtype), _t(xs).to(tdtype), [_t(a) for a in affine], tdtype)
    want = jax_upconv._apply_norm_affine(jnp.asarray(skip, jdtype), jnp.asarray(xs, jdtype),
                                         [jnp.asarray(a) for a in affine], jdtype)
    assert [g.dtype for g in got] == [tdtype if apply == "compute" and dtype == "bfloat16" else torch.float32] * 2
    _close(got, [np.asarray(w, np.float32) for w in want], TOL if dtype == "float32" else BF16_TOL)


# --- the fused joins ------------------------------------------------------------------------------------------


FUSED_MODES = {  # mode -> (xs shape, P3DUNET_UPCONV, P3DUNET_SKIPCONV)
    "full_wide": ((2, 2, 3, 4, 6), "wide", "fullres"),
    "full_strided": ((2, 2, 3, 4, 6), "wide", "strided"),
    "full_phase": ((2, 2, 3, 4, 6), "phase", "fullres"),
    "depth_only": ((2, 2, 6, 8, 6), "wide", "fullres"),
}


def _norm_kwargs(norm, rs, channels, xp):
    if norm == "groupnorm":
        return dict(num_groups=4, gn_scale=xp(_rand(rs, channels) * 0.3 + 1), gn_bias=xp(_rand(rs, channels) * 0.2))
    if norm == "batchnorm":
        return dict(affine=(xp(np.abs(_rand(rs, channels)) + 0.5), xp(_rand(rs, channels) * 0.2)))
    return dict(conv_bias=xp(_rand(rs, 5) * 0.1))


@pytest.mark.parametrize("norm", ["groupnorm", "batchnorm", "none"])
@pytest.mark.parametrize("mode", sorted(FUSED_MODES))
def test_fused_up_concat_conv_matches_jax(mode, norm, monkeypatch):
    xs_shape, up, skipconv = FUSED_MODES[mode]
    monkeypatch.setenv("P3DUNET_UPCONV", up)
    monkeypatch.setenv("P3DUNET_SKIPCONV", skipconv)
    rs = np.random.RandomState(7)
    skip, xs = _rand(rs, 2, 4, 6, 8, 2), _rand(rs, *xs_shape)
    kernel = _rand(rs, 3, 3, 3, 8, 5) / 10
    jax_kw = _norm_kwargs(norm, np.random.RandomState(8), 8, jnp.asarray)
    port_kw = _norm_kwargs(norm, np.random.RandomState(8), 8, _t)
    want = _jit(jax_upconv.fused_up_concat_conv)(jnp.asarray(skip), jnp.asarray(xs), jnp.asarray(kernel), **jax_kw)
    got = upconv.fused_up_concat_conv(_t(skip), _t(xs), _t(kernel), **port_kw)
    _close(got, want, TOL)


@pytest.mark.parametrize("apply", ["f32", "compute"])
@pytest.mark.parametrize("mode", ["full_wide", "depth_only"])
def test_fused_up_concat_conv_bf16_matches_jax(mode, apply, monkeypatch, jax_conv_rounding):  # noqa: F811
    monkeypatch.setenv("P3DUNET_GN_APPLY", apply)
    rs = np.random.RandomState(9)
    skip, xs = _rand(rs, 2, 4, 6, 8, 2), _rand(rs, *FUSED_MODES[mode][0])
    kernel = _rand(rs, 3, 3, 3, 8, 5) / 10
    jax_kw = _norm_kwargs("groupnorm", np.random.RandomState(8), 8, jnp.asarray)
    port_kw = _norm_kwargs("groupnorm", np.random.RandomState(8), 8, _t)
    want = _jit(jax_upconv.fused_up_concat_conv, dtype=jnp.bfloat16)(
        jnp.asarray(skip, jnp.bfloat16), jnp.asarray(xs, jnp.bfloat16), jnp.asarray(kernel), **jax_kw)
    got = upconv.fused_up_concat_conv(_t(skip).bfloat16(), _t(xs).bfloat16(), _t(kernel), dtype=torch.bfloat16,
                                      **port_kw)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("norm", ["groupnorm", "batchnorm", "none"])
def test_fused_up_concat_conv_2d_matches_jax(norm):
    rs = np.random.RandomState(10)
    skip, xs = _rand(rs, 2, 6, 8, 3), _rand(rs, 2, 3, 4, 5)
    kernel = _rand(rs, 3, 3, 8, 5) / 10
    want = _jit(jax_upconv.fused_up_concat_conv_2d)(jnp.asarray(skip), jnp.asarray(xs), jnp.asarray(kernel),
                                                    **_norm_kwargs(norm, np.random.RandomState(8), 8, jnp.asarray))
    got = upconv.fused_up_concat_conv_2d(_t(skip), _t(xs), _t(kernel),
                                         **_norm_kwargs(norm, np.random.RandomState(8), 8, _t))
    _close(got, want, TOL)


# --- the Decoder's choice -------------------------------------------------------------------------------------


CHOICE_SHAPES = {  # name -> (skip spatial, x spatial)
    "exact": ((8, 12, 16), (4, 6, 8)),
    "odd_hw": ((8, 13, 16), (4, 6, 8)),
    "non_2x_depth": ((9, 12, 16), (4, 6, 8)),
    "same_size": ((4, 6, 8), (4, 6, 8)),
    "exact_2d": ((12, 16), (6, 8)),
    "odd_2d": ((13, 16), (6, 8)),
}
CHOICE_DECODERS = {  # name -> Decoder options
    "gcr": {}, "bcr": {"order": "bcr"}, "cr": {"order": "cr"}, "cgr": {"order": "cgr"},
    "dropout": {"order": "gcrd"}, "anisotropic": {"conv_kernel_size": [1, 3, 3], "padding": [0, 1, 1]},
    "trilinear": {"upsample_mode": "trilinear"}, "sum_join": {"concat": False},
    "resnet": {"basic_module": "ResNetBlock"},
}


def _jax_choice(options, skip, x, rank):
    conv_kernel = options.get("conv_kernel_size", 3)
    padding = options.get("padding", 1)
    if rank == 2 and isinstance(conv_kernel, list):
        conv_kernel, padding = conv_kernel[1:], padding[1:]
    mode = options.get("upsample_mode", "nearest")
    decoder = jax_blocks.Decoder(out_channels=8, basic_module=options.get("basic_module", "DoubleConv"),
                                 conv_kernel_size=conv_kernel, conv_layer_order=options.get("order", "gcr"),
                                 num_groups=4, padding=padding, upsample_mode=mode if rank == 3 or mode != "trilinear"
                                 else "bilinear", concat=options.get("concat", True), spatial_rank=rank)
    return decoder._fused_path_ok(np.empty((1, *skip, 8)), np.empty((1, *x, 16)), False) or None


def _port_decoder(options, rank):
    options = dict(options)
    if rank == 2 and isinstance(options.get("conv_kernel_size"), list):
        options["conv_kernel_size"], options["padding"] = options["conv_kernel_size"][1:], options["padding"][1:]
    if rank == 2 and options.get("upsample_mode") == "trilinear":
        options["upsample_mode"] = "bilinear"
    return blocks.Decoder(16, 8, num_groups=4, is3d=rank == 3, **options)


@pytest.mark.parametrize("mixed", ["0", "1"])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_decoder_choice_matches_jax(fused, mixed, monkeypatch):
    """`Decoder.fused_mode` against JAX `_fused_path_ok` over shapes, orders,
    decoders and both switches (no mesh on either side)."""
    monkeypatch.setenv("P3DUNET_FUSED_DECODER", fused)
    monkeypatch.setenv("P3DUNET_FUSED_DECODER_MIXED", mixed)
    seen = set()
    for shape_name, (skip, x) in CHOICE_SHAPES.items():
        rank = len(skip)
        for name, options in CHOICE_DECODERS.items():
            want = _jax_choice(options, skip, x, rank)
            got = _port_decoder(options, rank).fused_mode((1, 8, *skip), (1, 16, *x))
            assert got == want, (shape_name, name)
            seen.add(got)
    assert seen == ({None} if fused == "0" else {None, "full", "mixed"} if mixed == "1" else {None, "full"})


def test_decoder_choice_under_a_mesh():
    """A space mesh always takes the generic path (as JAX under
    `active_spatial_axis`); a data mesh takes it for a train-mode BatchNorm
    before the conv, whose generic BatchNorm all-reduces its moments (sync
    BN), and keeps the fused path otherwise."""
    skip, x = (1, 8, 8, 12, 16), (1, 16, 4, 6, 8)
    gcr, bcr = _port_decoder({}, 3), _port_decoder({"order": "bcr"}, 3)
    assert gcr.fused_mode(skip, x) == bcr.fused_mode(skip, x) == "full"
    with spatial_axis(Mesh([0], name="space")):
        assert gcr.fused_mode(skip, x) is None and bcr.fused_mode(skip, x) is None
    with data_axis(Mesh([0])):
        assert gcr.fused_mode(skip, x) == "full"
        assert bcr.train().fused_mode(skip, x) is None
        assert bcr.eval().fused_mode(skip, x) == "full"
        # and the generic path's sync BN runs: its running statistics move
        model = get_model({**SMALL, "layer_order": "bcr"}).train()
        before = model.decoders[-1].basic_module.SingleConv1.batchnorm.running_mean.clone()
        model(torch.rand(1, 1, 8, 16, 16))
        assert not torch.equal(model.decoders[-1].basic_module.SingleConv1.batchnorm.running_mean, before)


# --- whole models against the JAX package at its defaults ---------------------------------------------------


SMALL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "f_maps": 8, "num_groups": 4, "num_levels": 3,
         "final_sigmoid": False}
MODELS = {  # case -> (model config, input spatial shape, switch, its fused and generic values)
    "unet3d": ({**SMALL, "layer_order": "gcr"}, (16, 32, 32), "P3DUNET_FUSED_DECODER", ("1", "0")),
    "resunet3d": ({**SMALL, "name": "ResidualUNet3D", "layer_order": "gcr"}, (8, 16, 16), "P3DUNET_DECONV",
                  ("phase", "xla")),
    "resunet3d_odd": ({**SMALL, "name": "ResidualUNet3D", "layer_order": "gcr"}, (10, 14, 18), "P3DUNET_DECONV",
                      ("phase", "xla")),
}


def _jax_model(cfg, seed):
    jax_model = jax_get_model(dict(cfg))
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return jax_model, {k: _randomize(v, rs) for k, v in variables.items()}


def _port_model(cfg, variables):
    model = get_model(dict(cfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@functools.cache
def _jax_forward(case):
    """(variables, input, logits) of the JAX model of `case` at its defaults."""
    cfg, spatial, _, _ = MODELS[case]
    jax_model, variables = _jax_model(cfg, 0)
    x = np.random.RandomState(5).rand(1, *spatial, 1).astype(np.float32)
    return variables, x, jax.jit(lambda v, xi: jax_model.apply(v, xi))(variables, x)[1]


@pytest.mark.parametrize("path", ["new", "generic"])
@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_forward_matches_jax(case, path, monkeypatch):
    cfg, _, switch, values = MODELS[case]
    variables, x, want = _jax_forward(case)
    monkeypatch.setenv(switch, values[path == "generic"])
    model = _port_model(cfg, variables).eval()
    with torch.inference_mode():
        _, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=0, atol=MODEL_TOL)


@pytest.mark.parametrize("case", ["unet3d", "resunet3d"])
def test_model_step_grads_match_jax_grad(case, monkeypatch):
    """One BCEDiceLoss step (the batches of tests/test_torch_port_train.py
    and _resunet.py; num_groups 4) through the fused decoder or the phase
    deconv: every
    parameter gradient against `jax.grad` of the JAX model at its defaults
    within 1e-4 of the step's max|g| and 1e-3 of the tensor's own (the JAX
    package's own f32 gradients sit up to 2.4e-3 of a tensor's max|g| from
    float64 here), and against the port's float64 step with the plain conv
    and the generic path within 1e-4 of each tensor's own max|g|."""
    cfg, _, switch, values = MODELS[case]
    if case == "unet3d":
        cfg = {**cfg, "out_channels": 1, "final_sigmoid": True}
        raw, target = _batches(1, seed=3, shape=(16, 32, 32))[0]
    else:  # tests/test_torch_port_resunet.py's model and batch
        cfg = {"name": cfg["name"], "layer_order": "gcr", **RES_BASE}
        raw, target = np.moveaxis(_input((8, 16, 16), seed=7), -1, 1), _target((8, 16, 16), 7)
    monkeypatch.setenv(switch, values[0])
    jax_model, variables = _jax_model(cfg, 3)
    criterion = jax_get_loss_criterion({"loss": dict(LOSS)})
    x, y = (jnp.asarray(np.moveaxis(a, 1, -1)) for a in (raw, target))

    @jax.jit
    def grad_fn(params):
        return jax.grad(lambda p: criterion(jax_model.module.apply({"params": p}, x, train=True)[1], y))(params)

    want = state_dict_from_jax({"params": grad_fn(variables["params"])})

    def port_grads(dtype, path):
        monkeypatch.setenv(switch, values[path])
        model = _port_model(cfg, variables).train().to(dtype)
        with conv3d.plain_conv() if dtype == torch.float64 else contextlib.nullcontext():
            logits = model(torch.from_numpy(raw).to(dtype))[1]
            get_loss_criterion({"loss": dict(LOSS)})(logits, torch.from_numpy(target).to(dtype)).backward()
        return {k: p.grad.double().numpy() for k, p in model.named_parameters()}

    got, want64 = port_grads(torch.float32, 0), port_grads(torch.float64, 1)
    assert set(got) == set(want)
    g_max = max(np.abs(g.numpy()).max() for g in want.values())
    for key, expected in want.items():
        expected = expected.numpy()
        np.testing.assert_allclose(got[key], expected, rtol=0, atol=GRAD_TOL * g_max, err_msg=key)
        np.testing.assert_allclose(got[key], expected, rtol=0, atol=1e-3 * np.abs(expected).max(), err_msg=key)
        own = max(np.abs(want64[key]).max(), 1e-6 * g_max)
        np.testing.assert_allclose(got[key], want64[key], rtol=0, atol=GRAD_TOL * own, err_msg=key)


def test_unet2d_bcr_train_mode_with_running_statistics():
    """UNet2D `bcr` fused at every level (JAX's default and the port's) in
    train mode: the logits, and every BatchNorm's running statistics moved as
    the port's generic BatchNorm moves them, the running variance's update
    n / (n - 1) times flax's (ROADMAP F2; n the values per channel of the
    norm's input, the concat's for a fused decoder)."""
    cfg = {**SMALL, "name": "UNet2D", "layer_order": "bcr"}
    jax_model, variables = _jax_model(cfg, 1)
    x = np.random.RandomState(6).rand(2, 32, 32, 1).astype(np.float32)
    (_, want), updated = jax.jit(lambda v, xi: jax_model.apply(v, xi, train=True, mutable=["batch_stats"]))(
        variables, x)
    model = _port_model(cfg, variables).train()
    assert [model.decoders[0].fused_mode((2, 16, 16, 16), (2, 32, 8, 8)),
            model.decoders[1].fused_mode((2, 8, 32, 32), (2, 16, 16, 16))] == ["full", "full"]
    _, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=0, atol=MODEL_TOL)
    before = state_dict_from_jax(variables)
    after = state_dict_from_jax({**variables, "batch_stats": updated["batch_stats"]})
    bns = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    # values per channel: the batch (2) times each level's plane
    sizes = {"encoders.0": 32, "encoders.1": 16, "encoders.2": 8, "decoders.0": 16, "decoders.1": 32}
    for key, bn in bns.items():
        n = 2 * sizes[key[:10]] ** 2
        np.testing.assert_allclose(bn.running_mean.numpy(), after[f"{key}.running_mean"].numpy(), rtol=0, atol=1e-5)
        old = 0.9 * before[f"{key}.running_var"].numpy()
        np.testing.assert_allclose(bn.running_var.numpy() - old,
                                   (after[f"{key}.running_var"].numpy() - old) * n / (n - 1), rtol=1e-4, atol=1e-6)
        assert bn.num_batches_tracked.item() == 1


@pytest.mark.parametrize("order", ["gcr", "bcr"])
def test_paths_share_the_state_dict_and_compute_the_same_function(order, monkeypatch):
    """The fused decoder and the phase deconv own no parameter: the state-dict
    keys are the generic path's, a checkpoint of one loads strict into the
    other, and the two forwards (train mode: BatchNorm's batch statistics and
    its running update) agree to f32 reassociation."""
    cfgs = [{**SMALL, "layer_order": order}, {**SMALL, "name": "ResidualUNet3D", "layer_order": order}]
    x = torch.from_numpy(np.random.RandomState(11).rand(2, 1, 8, 16, 16).astype(np.float32))
    for cfg in cfgs:
        outs = {}
        for fused, deconv in (("1", "phase"), ("0", "xla")):
            monkeypatch.setenv("P3DUNET_FUSED_DECODER", fused)
            monkeypatch.setenv("P3DUNET_DECONV", deconv)
            torch.manual_seed(0)
            model = get_model(cfg).train()
            outs[fused] = (model(x)[1].detach(), model.state_dict())
        (y_new, sd_new), (y_old, sd_old) = outs["1"], outs["0"]
        assert list(sd_new) == list(sd_old)
        get_model(cfg).load_state_dict(sd_new, strict=True)
        _close(y_new, y_old.numpy(), TOL)
        for key, value in sd_old.items():
            _close(sd_new[key].float(), value.float().numpy(), TOL)


def test_remat_grads_and_running_statistics_with_the_fused_decoder():
    """`model.remat` recomputes a fused decoder in backward: the gradients are
    the plain step's exactly and BatchNorm's running statistics move once."""
    x = torch.from_numpy(np.random.RandomState(13).randn(2, 1, 8, 16, 16).astype(np.float32))
    results = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = get_model({**SMALL, "layer_order": "bcr", "remat": remat}).train()
        model(x)[1].square().mean().backward()
        results[remat] = ({k: p.grad for k, p in model.named_parameters()}, dict(model.named_buffers()))
    for got, want in zip(results[True], results[False]):
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
    assert {int(v) for k, v in results[True][1].items() if k.endswith("num_batches_tracked")} == {1}


def test_exported_fused_decoder_keeps_the_custom_op(tmp_path):
    """A UNet3D whose decoders fuse traces through export.py: its graph calls
    the conv's custom op for every kernel conv of the plan (the fused
    decoders' two branches included), and the artifact equals the eager model."""
    cfg = {**SMALL, "layer_order": "gcr", "num_levels": 2}
    torch.manual_seed(0)
    model = get_model(cfg).eval()
    ckpt = tmp_path / "m.pytorch"
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    export_model({"device": "cpu", "model": cfg}, str(ckpt), str(tmp_path / "m.u3dx"), patch_shape=(8, 16, 16))
    program = load_exported(tmp_path / "m.u3dx")
    ops = [str(node.target) for node in program.program.graph.nodes]
    plan = kernel_conv_plan(model, (8, 16, 16))
    assert any(name.endswith("[up]") for name, *_ in plan)
    assert ops.count("pytorch3dunet_tpu_torch.conv3d_fwd.default") == len(plan)
    x = np.random.RandomState(1).rand(1, 8, 16, 16, 1).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(np.moveaxis(x, -1, 1)))[0].numpy()
    np.testing.assert_allclose(np.moveaxis(program(x), -1, 1), want, rtol=0, atol=1e-6)


# --- the launch plan ------------------------------------------------------------------------------------------


PLAN_SWITCHES = [{}, {"P3DUNET_TAPFOLD": "1"}, {"P3DUNET_FUSED_DECODER": "0", "P3DUNET_DECONV": "xla"},
                 {"P3DUNET_UPCONV": "phase"}, {"P3DUNET_SKIPCONV": "strided"}, {"P3DUNET_FUSED_DECODER_MIXED": "1"}]
# exact 2x, an odd H (mixed under the switch), an odd W with a BatchNorm prefix,
# and a ResidualUNet3D whose bottom convs have F = 64 (K1 under P3DUNET_TAPFOLD)
PLAN_MODELS = [({**SMALL, "layer_order": "gcr"}, (8, 16, 16)), ({**SMALL, "layer_order": "cr"}, (8, 18, 16)),
               ({**SMALL, "layer_order": "bcr"}, (8, 16, 18)),
               ({**SMALL, "name": "ResidualUNet3D", "f_maps": 16}, (8, 16, 16))]


@pytest.mark.parametrize("switches", PLAN_SWITCHES, ids=lambda s: ",".join(f"{k[8:]}={v}" for k, v in s.items())
                         or "defaults")
def test_kernel_conv_plan_is_what_the_model_calls(switches, monkeypatch):
    """`kernel_conv_plan` (which chip_smoke.py's launch gates derive from)
    against the calls of the conv's custom op on the CPU, where no launch is
    counted: the forward's (variant, input shape, F) and a train step's
    input gradients (K3)."""
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    calls = []
    op = conv3d.conv3d_op

    def counting(x, w, b, variant):
        calls.append((variant, tuple(x.shape), w.shape[-1]))
        return op(x, w, b, variant)

    monkeypatch.setattr(conv3d, "conv3d_op", counting)
    seen = set()
    for cfg, spatial in PLAN_MODELS:
        model = get_model(cfg).train()
        plan = kernel_conv_plan(model, spatial)
        calls.clear()
        logits = model(torch.rand(1, 1, *spatial))[1]
        assert sorted(calls) == sorted((variant, shape, f) for _, shape, f, variant, _ in plan), cfg
        calls.clear()
        logits.sum().backward()
        assert [v for v, *_ in calls] == ["packw"] * sum(grad for *_, grad in plan), cfg
        # under a space mesh every decoder is the generic one and the deconv the sharded one
        sharded = kernel_conv_plan(model, spatial, space_mesh=True)
        assert len(sharded) == sum(isinstance(m, conv3d.Conv3d) and m.on_kernels for m in model.modules())
        seen |= {variant for *_, variant, _ in plan} | {"fused" for name, *_ in plan if "[" in name}
    # the switches reached the cases: K1 convs under the tap fold, fused decoder branches unless it is off
    assert ("im2col" in seen) == (switches.get("P3DUNET_TAPFOLD") == "1")
    assert ("fused" in seen) == (switches.get("P3DUNET_FUSED_DECODER") != "0")


# --- the layout-only TPU knobs ----------------------------------------------------------------------------------


@pytest.mark.parametrize("knob,value", [("P3DUNET_PACKED", "1"), ("P3DUNET_POOL", "slice2"),
                                        ("P3DUNET_RESHAPE_POOL", "0"), ("P3DUNET_UP2X", "bc"),
                                        ("P3DUNET_DENSE_GN", "1"), ("P3DUNET_DENSE_BN", "1"), ("P3DUNET_SE", "mean"),
                                        ("P3DUNET_COMPILE_CACHE", "compile_cache")])
def test_layout_knobs_leave_the_forward_unchanged(knob, value, monkeypatch):
    """The JAX package's layout-only knobs choose a TPU layout or lowering of
    the same function; the port's layout is fixed and its norms apply in f32,
    so each is a no-op here: the forward is bitwise the same with it set."""
    x = torch.from_numpy(np.random.RandomState(12).rand(1, 1, 8, 16, 16).astype(np.float32))
    outs = []
    for setting in (None, value):
        if setting is not None:
            monkeypatch.setenv(knob, setting)
        for cfg in ({**SMALL, "layer_order": "bcr"}, {**SMALL, "name": "ResidualUNetSE3D", "num_levels": 2}):
            torch.manual_seed(0)
            model = get_model(cfg).train()
            outs.append(model(x)[1].detach())
    for before, after in zip(outs[:2], outs[2:]):
        torch.testing.assert_close(after, before, rtol=0, atol=0)
