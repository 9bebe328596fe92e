"""The port's device augmentation (pytorch3dunet_tpu_torch/ops/augment.py)
against the JAX package's (pytorch3dunet_tpu/ops/augment.py).

The two packages draw from different generators (ROADMAP F5), so every test
replays the JAX draws: it computes them from the JAX key exactly as the JAX op
splits it and hands them to the port's apply layer. The JAX samples are
channels-last (D, H, W, C), the port's (C, D, H, W) (F6). Raw outputs match
within RAW_TOL * max|out|; labels and label engineering exactly.
"""

import copy
import functools
import logging
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.scipy.ndimage import map_coordinates as jax_map_coordinates

from pytorch3dunet_tpu.ops import augment as jax_aug
from pytorch3dunet_tpu_torch.ops import augment as aug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# max |port - JAX| / max |JAX| of a raw output: f32 sums in another order
# (the spline prefilter's matmuls, the 64-tap cubic sum, the blur's conv) and
# the rotation's cos and sin rounded apart. Measured at most 3.50e-6 (rotate,
# order 3), 2.66e-6 elsewhere
RAW_TOL = 1e-5
SPATIAL = (12, 20, 20)  # square HW for rot90
CHANNELS = 2

TPU_TRAIN_CONFIGS = {
    "confocal_boundary": "3DUnet_confocal_boundary_tpu/train_config.yml",
    "lightsheet_boundary": "3DUnet_lightsheet_boundary_tpu/train_config.yml",
    "lightsheet_nuclei": "3DUnet_lightsheet_nuclei_tpu/train_config.yaml",
    "multiclass": "3DUnet_multiclass_tpu/train_config.yaml",
    "denoising": "3DUnet_denoising_tpu/train_config_regression.yaml",
}


def _raw(seed=0, channels=CHANNELS, spatial=SPATIAL):
    """(C, D, H, W) float32 raw, roughly standardized."""
    return np.random.RandomState(seed).randn(channels, *spatial).astype(np.float32)


def _label(seed=0, spatial=SPATIAL, cell=(3, 4, 4), ids=9):
    """(D, H, W) instance label of boxes with random ids 0..ids-1 (0 is background)."""
    rs = np.random.RandomState(seed)
    cells = rs.randint(0, ids, tuple(-(-s // c) for s, c in zip(spatial, cell)))
    return np.kron(cells, np.ones(cell, dtype=cells.dtype))[tuple(slice(s) for s in spatial)]


def _cl(x):
    """(C, D, H, W) -> the JAX sample layout (D, H, W, C)."""
    return np.moveaxis(np.asarray(x), 0, -1)


def _cf(x):
    """A JAX (D, H, W, C) result -> (C, D, H, W) numpy."""
    return np.moveaxis(np.asarray(x), -1, 0)


def _assert_raw(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=RAW_TOL * np.abs(want).max())


def _assert_exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


# --- the JAX draws, replayed ------------------------------------------------------------------------------------


def _f(x) -> float:
    return float(np.asarray(x))


def _i(x) -> int:
    return int(np.asarray(x))


def jax_flip(key):
    return {"u": [float(u) for u in np.asarray(jax.random.uniform(key, (3,)))]}


def jax_rotate90(key):
    return {"k": _i(jax.random.randint(key, (), 0, 4))}


def jax_rotate(key, n_planes, angle_spectrum):
    ka, kx = jax.random.split(key)
    return {"plane": _i(jax.random.randint(ka, (), 0, n_planes)),
            "angle": _f(jax.random.uniform(kx, (), minval=-angle_spectrum, maxval=angle_spectrum))}


def jax_contrast(key, alpha):
    kp, ka = jax.random.split(key)
    return {"u": _f(jax.random.uniform(kp)), "alpha": _f(jax.random.uniform(ka, (), minval=alpha[0], maxval=alpha[1]))}


def jax_gaussian_noise(key, shape_cl, scale):
    kp, ks, kn = jax.random.split(key, 3)
    return {"u": _f(jax.random.uniform(kp)), "std": _f(jax.random.uniform(ks, (), minval=scale[0], maxval=scale[1])),
            "noise": torch.from_numpy(_cf(jax.random.normal(kn, shape_cl, dtype=np.float32)).copy())}


def jax_poisson_noise(key, shape_cl, lam):
    kp, kl, kn = jax.random.split(key, 3)
    rate = jax.random.uniform(kl, (), minval=lam[0], maxval=lam[1])
    noise = jax.random.poisson(kn, rate, shape_cl).astype(np.float32)
    return {"u": _f(jax.random.uniform(kp)), "rate": _f(rate), "noise": torch.from_numpy(_cf(noise).copy())}


def jax_blur(key, sigma):
    kp, ks = jax.random.split(key)
    return {"u": _f(jax.random.uniform(kp)), "sigma": _f(jax.random.uniform(ks, (), minval=sigma[0], maxval=sigma[1]))}


def jax_elastic(key, spatial, apply_3d=True, grid_downsample=8):
    kp, kz, ky, kx = jax.random.split(key, 4)
    coarse = tuple(max(2, s // grid_downsample) for s in spatial)
    fields = [torch.from_numpy(np.array(jax.random.normal(k, coarse, dtype=np.float32)))
              if apply_3d or axis else None for axis, k in enumerate((kz, ky, kx))]
    return {"u": _f(jax.random.uniform(kp)), "fields": fields}


def jax_label_to_affinities(key, max_offset):
    ko, ka = jax.random.split(key)
    return {"offset": _i(jax.random.randint(ko, (), 1, max_offset + 1)), "axis": _i(jax.random.randint(ka, (), 0, 3))}


def jax_op_draw(cfg, key, shape):
    """The draw of one spec entry from its JAX key, as the JAX op splits it;
    `shape` is the port's (C, D, H, W) sample shape."""
    name = cfg["name"]
    shape_cl = (*shape[1:], shape[0])
    if name == "RandomFlip":
        return jax_flip(key)
    if name == "RandomRotate90":
        return jax_rotate90(key)
    if name == "RandomRotate":
        return jax_rotate(key, len(aug._rotate_axes(cfg)), cfg.get("angle_spectrum", 30))
    if name == "ElasticDeformation":
        return jax_elastic(key, shape[1:], cfg.get("apply_3d", True))
    if name == "AdditiveGaussianNoise":
        return jax_gaussian_noise(key, shape_cl, tuple(cfg.get("scale", (0.0, 1.0))))
    if name == "AdditivePoissonNoise":
        return jax_poisson_noise(key, shape_cl, tuple(cfg.get("lam", (0.0, 1.0))))
    if name == "GaussianBlur3D":
        return jax_blur(key, tuple(cfg.get("sigma", (0.1, 2.0))))
    if name == "RandomContrast":
        return jax_contrast(key, tuple(cfg.get("alpha", (0.5, 1.5))))
    raise ValueError(name)


def jax_augmenter_draws(spec, key, raw_shape):
    """The port-format draws of a batch, from the key the JAX DeviceAugmenter
    is called with: one key per sample, split once per transform in spec
    order (JAX augment.py:570-690, :712)."""
    draws = []
    for k in jax.random.split(key, raw_shape[0]):
        sample = {"paired": [], "raw_only": [], "label_post": None}
        for part, cfgs in (("paired", [e["raw"] for e in spec["paired"]]), ("raw_only", spec["raw_only"])):
            for cfg in cfgs:
                k, sub = jax.random.split(k)
                sample[part].append(jax_op_draw(cfg, sub, raw_shape[1:]))
        post = spec.get("label_post")
        if post is not None and post["name"] == "RandomLabelToAffinities":
            k, sub = jax.random.split(k)
            sample["label_post"] = jax_label_to_affinities(sub, post.get("max_offset", 10))
        draws.append(sample)
    return draws


# --- intensity ops ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_flip_and_rot90_match_jax(seed):
    x = _raw(seed)
    label = _label(seed)[None]
    key = jax.random.PRNGKey(seed)
    for axis_prob in (0.5, 0.2):
        d = jax_flip(key)
        _assert_exact(aug.random_flip(torch.from_numpy(x), d["u"], axis_prob), _cf(jax_aug.random_flip(key, _cl(x),
                                                                                                       axis_prob)))
    d = jax_rotate90(key)
    _assert_exact(aug.random_rotate90(torch.from_numpy(x), d["k"]), _cf(jax_aug.random_rotate90(key, _cl(x))))
    kf, kr = jax.random.split(key)
    raw_j, lab_j = jax_aug.paired_geometric(key, _cl(x), _cl(label))
    raw_p, lab_p = aug.paired_geometric(torch.from_numpy(x), torch.from_numpy(label), jax_flip(kf), jax_rotate90(kr))
    _assert_exact(raw_p, _cf(raw_j))
    _assert_exact(lab_p, _cf(lab_j))


@pytest.mark.parametrize("op", ["contrast", "gaussian_noise", "poisson_noise", "blur"])
@pytest.mark.parametrize("seed", [0, 1])
def test_intensity_op_matches_jax(op, seed):
    x = _raw(seed)
    key = jax.random.PRNGKey(10 + seed)
    xt = torch.from_numpy(x)
    if op == "contrast":
        want = jax_aug.random_contrast(key, _cl(x), (0.5, 1.5), 0.1, 1.0)
        d = jax_contrast(key, (0.5, 1.5))
        got = aug.random_contrast(xt, d["u"], d["alpha"], 0.1, 1.0)
    elif op == "gaussian_noise":
        want = jax_aug.additive_gaussian_noise(key, _cl(x), (0.0, 1.0), 1.0)
        d = jax_gaussian_noise(key, _cl(x).shape, (0.0, 1.0))
        got = aug.additive_gaussian_noise(xt, d["u"], d["std"], d["noise"], 1.0)
    elif op == "poisson_noise":
        want = jax_aug.additive_poisson_noise(key, _cl(x), (0.5, 2.0), 1.0)
        d = jax_poisson_noise(key, _cl(x).shape, (0.5, 2.0))
        got = aug.additive_poisson_noise(xt, d["u"], d["noise"], 1.0)
    else:
        want = jax_aug.gaussian_blur(key, _cl(x), (0.1, 2.0), 1.0)
        d = jax_blur(key, (0.1, 2.0))
        got = aug.gaussian_blur(xt, d["u"], d["sigma"], 1.0)
    _assert_raw(got, _cf(want))


@pytest.mark.parametrize("sigma,radius", [(0.3, 8), (1.7, 8), (6.25, 12)])
def test_separable_gaussian_1d_matches_jax(sigma, radius):
    _assert_raw(aug._separable_gaussian_1d(sigma, radius), jax_aug._separable_gaussian_1d(sigma, radius))


# --- geometry -----------------------------------------------------------------------------------------------


def _edge_coords(shape, seed):
    """Per-axis coordinates outside the volume, at exact half-integers
    (inside and out) and at random points, broadcast to one (8, 9, 10) grid."""
    rs = np.random.RandomState(seed)
    out = []
    for axis, n in enumerate(shape):
        special = np.array([-2 * n - 0.5, -n - 1.5, -3.5, -0.5, -0.25, 0.0, 0.5, 1.5, n - 1.5, n - 0.5, n - 0.25,
                            n + 0.5, n + 2.5, 2 * n + 3.5, 3 * n + 0.5], dtype=np.float32)
        values = np.concatenate([special, (rs.rand(40) * 3 * n - n).astype(np.float32)])
        out.append(values[rs.randint(0, len(values), (8, 9, 10))])
    return out


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_map_coordinates_outside_and_at_half_integers_matches_jax(order, seed):
    data = np.random.RandomState(seed).randn(5, 7, 6).astype(np.float32)
    coords = _edge_coords(data.shape, seed)
    port_coords = [torch.from_numpy(c) for c in coords]
    if order == 3:
        want = jax_aug.map_coordinates_cubic(data, coords)
        got = aug.map_coordinates_cubic(torch.from_numpy(data), port_coords)
    else:
        want = jax_map_coordinates(data, coords, order=order, mode="reflect")
        got = aug.map_coordinates(torch.from_numpy(data), port_coords, order)
    if order == 0:
        _assert_exact(got, want)
    else:
        _assert_raw(got, want)


def test_half_integers_round_away_from_zero():
    t = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -0.49999997, 3.0])
    assert aug._round_half_away(t).tolist() == [-3.0, -2.0, -1.0, 1.0, 2.0, 3.0, 0.0, -0.0, 3.0]
    i = torch.arange(-13, 14)
    np.testing.assert_array_equal(aug._reflect_index(i, 5).numpy(), np.asarray(jax_aug._reflect_index(i.numpy(), 5)))


@pytest.mark.parametrize("n", [1, 2, 5, 80, 170])
def test_bspline_inverse_matrix_matches_jax(n):
    np.testing.assert_array_equal(aug._bspline3_inverse_matrix(n), np.asarray(jax_aug._bspline3_inverse_matrix(n)))
    data = np.random.RandomState(n).randn(n, 3, 4).astype(np.float32)
    _assert_raw(aug._bspline3_prefilter(torch.from_numpy(data)), jax_aug._bspline3_prefilter(data))


@pytest.mark.parametrize("shape_in,shape_out", [((2, 2, 2), (12, 20, 20)), ((10, 21, 21), (80, 170, 170)),
                                                ((2, 3, 4), (1, 3, 9))])
def test_linear_resize_matches_jax_image_resize(shape_in, shape_out):
    f = np.random.RandomState(0).randn(*shape_in).astype(np.float32)
    _assert_raw(aug._linear_resize(torch.from_numpy(f), shape_out), jax.image.resize(f, shape_out, method="linear"))


# an elastic field strong enough to move labels at this size: sigma 4 on a
# grid 2x coarser, and the recipe's default on its 8x coarser grid
ELASTIC_CASES = [{"alpha": 30.0, "sigma": 4.0, "grid_downsample": 2}, {"alpha": 2000.0, "sigma": 50.0}]


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("case", range(len(ELASTIC_CASES)))
@pytest.mark.parametrize("apply_3d", [True, False])
def test_elastic_deformation_matches_jax(order, case, apply_3d):
    kwargs = dict(ELASTIC_CASES[case], apply_3d=apply_3d, execution_probability=1.0)
    key = jax.random.PRNGKey(100 + order + 3 * case)
    d = jax_elastic(key, SPATIAL, apply_3d, kwargs.get("grid_downsample", 8))
    x = _raw(case)
    want = _cf(jax_aug.elastic_deformation(key, _cl(x), order, **kwargs))
    _assert_raw(aug.elastic_deformation(torch.from_numpy(x), d["u"], d["fields"], order, **kwargs), want)
    label = _label(case)[None].astype(np.float32)
    want_label = _cf(jax_aug.elastic_deformation(key, _cl(label), 0, **kwargs))
    got_label = aug.elastic_deformation(torch.from_numpy(label), d["u"], d["fields"], 0, **kwargs)
    _assert_exact(got_label, want_label)
    if case == 0:
        assert (want_label != label).mean() > 0.02  # the field moved the label


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("axes", [((2, 1),), ((1, 0), (2, 1), (2, 0))])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_rotate_matches_jax(order, axes, seed):
    key = jax.random.PRNGKey(200 + seed)
    d = jax_rotate(key, len(axes), 45)
    x = _raw(seed)
    _assert_raw(aug.random_rotate(torch.from_numpy(x), d["plane"], d["angle"], axes, order),
                _cf(jax_aug.random_rotate(key, _cl(x), axes, 45, spline_order=order)))
    label = _label(seed)[None].astype(np.float32)
    _assert_exact(aug.random_rotate(torch.from_numpy(label), d["plane"], d["angle"], axes, 0),
                  _cf(jax_aug.random_rotate(key, _cl(label), axes, 45, spline_order=0)))


# --- label engineering --------------------------------------------------------------------------------------


def _engineering_cases():
    return {
        "thick_boundary": (lambda lab: jax_aug.thick_boundary(lab), lambda lab: aug.thick_boundary(lab)),
        "thick_boundary_c1": (lambda lab: jax_aug.thick_boundary(lab, 1), lambda lab: aug.thick_boundary(lab, 1)),
        "standard_label_to_boundary": (
            lambda lab: jax_aug.standard_label_to_boundary(lab, ignore_index=3, append_label=True, foreground=True),
            lambda lab: aug.standard_label_to_boundary(lab, ignore_index=3, append_label=True, foreground=True)),
        "standard_plain": (lambda lab: jax_aug.standard_label_to_boundary(lab),
                           lambda lab: aug.standard_label_to_boundary(lab)),
        "blobs_to_mask": (lambda lab: jax_aug.blobs_to_mask(lab, append_label=True),
                          lambda lab: aug.blobs_to_mask(lab, append_label=True)),
        "label_to_affinities": (
            lambda lab: jax_aug.label_to_affinities(lab, [1, 3, 6], z_offsets=[1, 2, 3], append_label=True,
                                                    ignore_index=3),
            lambda lab: aug.label_to_affinities(lab, [1, 3, 6], z_offsets=[1, 2, 3], append_label=True,
                                                ignore_index=3)),
        "label_to_affinities_aggregate": (
            lambda lab: jax_aug.label_to_affinities(lab, [2, 4], aggregate_affinities=True),
            lambda lab: aug.label_to_affinities(lab, [2, 4], aggregate_affinities=True)),
        "label_to_z_affinities": (
            lambda lab: jax_aug.label_to_z_affinities(lab, [1, 2, 5], append_label=True, ignore_index=0),
            lambda lab: aug.label_to_z_affinities(lab, [1, 2, 5], append_label=True, ignore_index=0)),
        "label_to_boundary_and_affinities": (
            lambda lab: jax_aug.label_to_boundary_and_affinities(lab, [1, 4], [1, 2], append_label=True,
                                                                 ignore_index=3, foreground=True),
            lambda lab: aug.label_to_boundary_and_affinities(lab, [1, 4], [1, 2], append_label=True, ignore_index=3,
                                                             foreground=True)),
        "label_to_mask_and_affinities": (
            lambda lab: jax_aug.label_to_mask_and_affinities(lab, [1, 4], [1, 2], append_label=True, background=2),
            lambda lab: aug.label_to_mask_and_affinities(lab, [1, 4], [1, 2], append_label=True, background=2)),
    }


@pytest.mark.parametrize("name", list(_engineering_cases()))
def test_label_engineering_matches_jax(name):
    jax_fn, port_fn = _engineering_cases()[name]
    label = _label(7).astype(np.float32)
    want = np.asarray(jax_fn(label))
    got = port_fn(torch.from_numpy(label))
    _assert_exact(got, want if want.ndim == 3 else _cf(want))


@pytest.mark.parametrize("seed", range(4))
def test_random_label_to_affinities_matches_jax(seed):
    label = _label(seed).astype(np.float32)
    key = jax.random.PRNGKey(300 + seed)
    d = jax_label_to_affinities(key, 10)
    want = jax_aug.random_label_to_affinities(key, label, max_offset=10, z_offset_scale=2, append_label=True,
                                              ignore_index=0)
    got = aug.random_label_to_affinities(torch.from_numpy(label), d["offset"], d["axis"], z_offset_scale=2,
                                         append_label=True, ignore_index=0)
    _assert_exact(got, _cf(want))


# --- a skipped transform returns its input ------------------------------------------------------------------


@pytest.mark.parametrize("op", ["contrast", "gaussian_noise", "poisson_noise", "blur", "elastic"])
def test_a_skipped_transform_returns_its_input(op):
    x = _raw(3)
    xt = torch.from_numpy(x)
    key = jax.random.PRNGKey(3)
    if op == "contrast":
        got = aug.random_contrast(xt, 0.5, 1.3, 0.0, 0.0)
        want = jax_aug.random_contrast(key, _cl(x), (0.5, 1.5), 0.0, 0.0)
    elif op == "gaussian_noise":
        got = aug.additive_gaussian_noise(xt, 0.5, 0.3, None, 0.0)
        want = jax_aug.additive_gaussian_noise(key, _cl(x), (0.0, 1.0), 0.0)
    elif op == "poisson_noise":
        got = aug.additive_poisson_noise(xt, 0.5, None, 0.0)
        want = jax_aug.additive_poisson_noise(key, _cl(x), (0.0, 1.0), 0.0)
    elif op == "blur":
        got = aug.gaussian_blur(xt, 0.5, 1.0, 0.0)
        want = jax_aug.gaussian_blur(key, _cl(x), (0.1, 2.0), 0.0)
    else:
        got = aug.elastic_deformation(xt, 0.5, None, 3, execution_probability=0.0)
        want = jax_aug.elastic_deformation(key, _cl(x), 3, execution_probability=0.0)
    assert got is xt  # no work, not even a copy
    _assert_exact(got, _cf(want))


def test_draws_skip_the_fields_of_a_skipped_transform():
    host, device_gen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)
    assert aug.draw_gaussian_noise(host, device_gen, (1, 4, 4, 4), execution_probability=0.0)["noise"] is None
    assert aug.draw_elastic(host, device_gen, (4, 4, 4), execution_probability=0.0)["fields"] is None
    d = aug.draw_elastic(host, device_gen, (16, 20, 20), execution_probability=1.0, apply_3d=False)
    assert d["fields"][0] is None and [tuple(f.shape) for f in d["fields"][1:]] == [(2, 2, 2)] * 2


# --- config: split_device_transforms ------------------------------------------------------------------------


@functools.cache
def _train_config(name):
    with open(os.path.join(REPO, "resources", TPU_TRAIN_CONFIGS[name])) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("name", list(TPU_TRAIN_CONFIGS))
def test_split_device_transforms_matches_jax_on_tpu_configs(name):
    loaders = _train_config(name)["loaders"]
    jax_loaders, port_loaders = copy.deepcopy(loaders), copy.deepcopy(loaders)
    want = jax_aug.split_device_transforms(jax_loaders)
    got = aug.split_device_transforms(port_loaders)
    assert got == want and port_loaders == jax_loaders
    assert got["paired"] or got["raw_only"]


def _guard_loaders(label_tfs, raw_tfs):
    return {"device_augment": True, "train": {"transformer": {"raw": raw_tfs, "label": label_tfs}}}


_ELASTIC = {"name": "ElasticDeformation", "spline_order": 3}
_TO_TENSOR = {"name": "ToTensor", "expand_dims": False}


@pytest.mark.parametrize("case", ["order_sensitive_kept_on_host", "label_only_geometric_kept", "disabled"])
def test_split_device_transforms_guards_match_jax(case, caplog):
    if case == "order_sensitive_kept_on_host":
        # boundary engineering without a device op (mode 'inner') stays on the
        # host, so the elastic and rotate that precede it stay there too
        raw = [{"name": "RandomFlip"}, dict(_ELASTIC), {"name": "RandomRotate", "axes": [[2, 1]]},
               {"name": "AdditiveGaussianNoise"}, {"name": "ToTensor", "expand_dims": True}]
        label = [{"name": "RandomFlip"}, dict(_ELASTIC, spline_order=0), {"name": "RandomRotate", "axes": [[2, 1]]},
                 {"name": "StandardLabelToBoundary", "mode": "inner"}, dict(_TO_TENSOR)]
        loaders = _guard_loaders(label, raw)
    elif case == "label_only_geometric_kept":
        # a RandomRotate90 of the label alone has no raw counterpart: it stays
        raw = [{"name": "RandomFlip"}, {"name": "ToTensor", "expand_dims": True}]
        label = [{"name": "RandomFlip"}, {"name": "RandomRotate90"}, {"name": "BlobsToMask"}, dict(_TO_TENSOR)]
        loaders = _guard_loaders(label, raw)
    else:
        loaders = dict(_guard_loaders([], []), device_augment=False)
    jax_loaders, port_loaders = copy.deepcopy(loaders), copy.deepcopy(loaders)
    with caplog.at_level(logging.WARNING):
        got = aug.split_device_transforms(port_loaders)
    want = jax_aug.split_device_transforms(jax_loaders)
    assert got == want and port_loaders == jax_loaders
    port_tf = port_loaders["train"]["transformer"]
    if case == "order_sensitive_kept_on_host":
        assert [t["name"] for t in port_tf["raw"]] == ["ElasticDeformation", "RandomRotate", "ToTensor"]
        assert [e["raw"]["name"] for e in got["paired"]] == ["RandomFlip"] and got["label_post"] is None
        assert any("has no device kernel" in r.getMessage() for r in caplog.records if r.name == "DeviceAugment")
    elif case == "label_only_geometric_kept":
        assert [t["name"] for t in port_tf["label"]] == ["RandomRotate90", "BlobsToMask", "ToTensor"]
    else:
        assert got is None


# --- DeviceAugmenter ----------------------------------------------------------------------------------------


def _batch(name, n=2, spatial=SPATIAL):
    """An NCDHW raw batch and its label batch with a channel axis, as the
    stripped host pipeline of config `name` yields them: int64 class labels
    for multiclass, a float raw-like target for denoising, float instance
    labels otherwise."""
    raw = np.stack([_raw(10 + i, 1, spatial) for i in range(n)])
    if name == "denoising":
        label = np.stack([_raw(20 + i, 1, spatial) for i in range(n)])
    else:
        label = np.stack([_label(30 + i, spatial)[None] for i in range(n)])
        label = label.astype(np.int64 if name == "multiclass" else np.float32)
    return raw, label


@functools.cache
def _spec(name, all_run):
    spec = aug.split_device_transforms(copy.deepcopy(_train_config(name)["loaders"]))
    return aug.execution_probability_one(spec) if all_run else spec


@pytest.mark.parametrize("all_run", [False, True])
@pytest.mark.parametrize("name", list(TPU_TRAIN_CONFIGS))
def test_device_augmenter_matches_jax_with_replayed_keys(name, all_run):
    spec = _spec(name, all_run)
    raw, label = _batch(name)
    key = jax.random.PRNGKey(42)
    want_raw, want_label = jax_aug.DeviceAugmenter(spec)(key, np.moveaxis(raw, 1, -1), np.moveaxis(label, 1, -1))
    draws = jax_augmenter_draws(spec, key, raw.shape)
    got_raw, got_label = aug.DeviceAugmenter(spec).apply(torch.from_numpy(raw), torch.from_numpy(label), draws)
    _assert_raw(got_raw, np.moveaxis(np.asarray(want_raw), -1, 1))
    want_label = np.moveaxis(np.asarray(want_label), -1, 1)
    # the label keeps its dtype (the JAX package without x64 makes int64 int32)
    assert got_label.dtype == torch.from_numpy(label).dtype and want_label.dtype.kind == label.dtype.kind
    (_assert_raw if name == "denoising" else _assert_exact)(got_label, want_label)
    if spec["label_post"] is not None:
        assert got_label.shape[1] == 2  # engineered channel + the appended label


def test_non_square_batch_skips_rot90_with_a_warning(caplog):
    spec = {"paired": [{"raw": {"name": "RandomRotate90"}, "label": {"name": "RandomRotate90"}}], "raw_only": [],
            "label_post": None}
    raw, label = _batch("confocal_boundary", n=1, spatial=(4, 6, 8))
    augmenter = aug.DeviceAugmenter(spec)
    gens = (torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    with caplog.at_level(logging.WARNING):
        got_raw, got_label = augmenter(torch.from_numpy(raw), torch.from_numpy(label), gens)
    assert any("SKIPPED" in r.getMessage() for r in caplog.records if r.name == "DeviceAugment")
    _assert_exact(got_raw, raw)
    _assert_exact(got_label, label)


def test_augmenter_apply_makes_no_host_sync(monkeypatch):
    spec = _spec("confocal_boundary", True)
    raw, label = _batch("confocal_boundary")
    augmenter = aug.DeviceAugmenter(spec)
    draws = augmenter.draw(raw.shape, (torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)))

    def refuse(*args, **kwargs):
        raise AssertionError("host sync inside the device augmentation")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        got_raw, got_label = augmenter.apply(torch.from_numpy(raw), torch.from_numpy(label), draws)
    assert got_raw.shape == raw.shape and got_label.shape == (2, 2, *SPATIAL)
    assert torch.isfinite(got_raw).all()


def test_augmenter_draws_are_reproducible_from_the_seeds():
    spec = _spec("lightsheet_nuclei", True)
    raw, label = (torch.from_numpy(a) for a in _batch("lightsheet_nuclei"))
    outs = []
    for _ in range(2):
        gens = (torch.Generator().manual_seed(5), torch.Generator().manual_seed(6))
        outs.append(aug.DeviceAugmenter(spec)(raw, label, gens))
    for a, b in zip(*outs):
        _assert_exact(a, b)
