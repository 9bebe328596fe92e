"""The port's device sweep (pytorch3dunet_tpu_torch/inference_device.py and
predictor.py `DeviceSlidingWindowPredictor`) against the JAX package's
`DeviceSlidingWindowPredictor` on the CPU: the same seeded volumes, the same
weights (JAX init, norm affines perturbed, crossed with the export), within
2e-4. The JAX predictor runs with `shard: false`: the tests' 8 virtual CPU
devices would otherwise shard its grid, and the port runs on one device.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch3dunet_tpu import inference_device as jax_inference_device
from pytorch3dunet_tpu import predictor as jax_predictor
from pytorch3dunet_tpu.datasets.utils import get_test_loaders as jax_get_test_loaders
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.predict import get_predictor as jax_get_predictor
from pytorch3dunet_tpu_torch import inference_device, predictor
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow, _percentile
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import get_predictor
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor, StandardPredictor
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax

TOL = 2e-4
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8, "num_groups": 4,
         "num_levels": 2, "final_sigmoid": False}
HALO = (2, 4, 4)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port model with the same weights)."""
    jax_model = jax_get_model(dict(MODEL))
    rs = np.random.RandomState(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (rs.rand(*v.shape).astype(np.float32) + 0.5) if path[-1].key == "scale"
        else (rs.rand(*v.shape).astype(np.float32) * 0.4 - 0.2) if path[-1].key == "bias" else np.asarray(v),
        jax.jit(jax_model.init)(jax.random.PRNGKey(0)))
    model = get_model(dict(MODEL))
    model.load_state_dict(state_dict_from_jax(variables))
    return jax_model, variables, model.eval()


def _volume(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(*shape) * 3 + 1).astype(np.float32)


def _both(models, volume, patch, stride, normalize, stats, **predictor_kwargs):
    """predict_array of the JAX and of the port predictor, (Cout, D, H, W) each."""
    jax_model, variables, model = models
    want = jax_predictor.DeviceSlidingWindowPredictor(jax_model, variables, None, 2, shard=False, **predictor_kwargs)
    got = DeviceSlidingWindowPredictor(model, None, 2, "cpu", **predictor_kwargs)
    args = (volume, patch, stride, HALO)
    return want.predict_array(*args, normalize=normalize, stats=stats), got.predict_array(*args, normalize=normalize,
                                                                                          stats=stats)


def _standardize(volume):
    return "standardize", {"mean": float(volume.mean()), "std": float(volume.std())}


@pytest.mark.parametrize("shape,patch,stride,blend", [
    ((16, 32, 32), (8, 16, 16), (8, 16, 16), "assign"),    # exact fit
    ((12, 40, 36), (8, 16, 16), (8, 16, 16), "assign"),    # ragged: flush tail patches overlap
    ((12, 40, 36), (8, 16, 16), (4, 8, 8), "gaussian"),    # overlapping
    ((12, 40, 36), (8, 16, 16), (4, 8, 8), "assign"),      # overlapping, write-wins
])
def test_sweep_matches_jax(models, shape, patch, stride, blend):
    volume = _volume(shape)
    want, got = _both(models, volume, patch, stride, *_standardize(volume), blend=blend)
    assert got.shape == want.shape == (2, *shape)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("normalize,stats", [("standardize", None), ("standardize_patch", {}), ("normalize", {}),
                                             ("percentile", {"pmin": 2.0, "pmax": 99.0})])
def test_each_normalize_mode_matches_jax(models, normalize, stats):
    volume = _volume((12, 40, 36), seed=3)
    if stats is None:
        normalize, stats = _standardize(volume)
    want, got = _both(models, volume, (8, 16, 16), (4, 8, 8), normalize, stats, blend="gaussian")
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("option", [{"patch_batch": 2}, {"tta": True}, {"tta": True, "tta_axes": [2]}])
def test_patch_batch_and_tta_match_jax(models, option):
    volume = _volume((12, 40, 36), seed=4)
    want, got = _both(models, volume, (8, 16, 16), (8, 16, 16), *_standardize(volume), **option)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("blend", ["assign", "gaussian"])
def test_streamed_sweep_matches_one_shot_and_jax(models, blend):
    # a budget of 2 padded 10-plane slabs: the z-levels stream in 3 slabs
    volume = _volume((24, 40, 36), seed=5)
    budget = 2 * 10 * (40 + 8) * (36 + 8)
    grid = (volume, (6, 16, 16), (6, 16, 16) if blend == "assign" else (3, 8, 8), HALO)
    normalize, stats = _standardize(volume)
    want, got = _both(models, *grid[:3], normalize, stats, blend=blend, max_device_voxels=budget)
    one_shot = DeviceSlidingWindowPredictor(models[2], None, 2, "cpu", blend=blend).predict_array(
        *grid, normalize=normalize, stats=stats)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, one_shot, atol=1e-5)


PLANS = [  # (spatial, patch, halo, budget): the geometries of the JAX planner tests
    ((8, 16, 16), (4, 8, 8), (2, 2, 2), 2**24),
    ((100, 32, 32), (16, 16, 16), (2, 2, 2), 1296 * 74),
    ((100, 32, 32), (16, 16, 16), (2, 2, 2), 1296 * 40),
    ((100, 512, 512), (16, 64, 64), (2, 2, 2), 10000),
    ((100, 96, 512), (16, 32, 32), (2, 2, 2), 2**21),
]


@pytest.mark.parametrize("spatial,patch,halo,budget", PLANS)
def test_planners_equal_jax(spatial, patch, halo, budget):
    for port_plan, jax_plan in ((predictor._plan_slab_grid, jax_predictor._plan_slab_grid),
                                (predictor._plan_strip_grid, jax_predictor._plan_strip_grid)):
        got, want = port_plan(spatial, patch, halo, 1, budget), jax_plan(spatial, patch, halo, 1, budget)
        assert (got is None) == (want is None)
        if want is not None:
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("max_patch_voxels,patch_shape", [(2**24, (8, 160, 96)), (12 * 72 * 104, (8, 64, 96))])
def test_slab_and_strip_modes_match_jax(models, max_patch_voxels, patch_shape):
    # the whole volume in one slab, or (the padded plane over the budget)
    # three full-x strips 64 deep in y
    volume = _volume((8, 160, 96), seed=6)
    port = DeviceSlidingWindowPredictor(models[2], None, 2, "cpu", patch_mode="slab", max_patch_voxels=max_patch_voxels)
    assert port._plan_geometry(volume.shape, (8, 64, 64), np.zeros((6, 3)), HALO, 1)[0] == patch_shape
    want, got = _both(models, volume, (8, 64, 64), (8, 64, 64), *_standardize(volume), patch_mode="slab",
                      max_patch_voxels=max_patch_voxels)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_read_padded_slab_equals_jax():
    raw = _volume((2, 9, 10, 11), seed=7)
    for z_lo, z_hi in ((0, 5), (3, 13)):
        np.testing.assert_array_equal(predictor._read_padded_slab(raw, (2, 3, 1), z_lo, z_hi),
                                      jax_predictor._read_padded_slab(raw, (2, 3, 1), z_lo, z_hi))


@pytest.mark.parametrize("raw", [
    [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}],
    [{"name": "Standardize", "mean": 2.0, "std": 3.0}],
    [{"name": "Normalize"}], [{"name": "Normalize", "norm01": True}], [{"name": "PercentileNormalizer", "pmin": 5}],
    [{"name": "Standardize", "channelwise": True}], [{"name": "ToTensor"}], [{"name": "GaussianBlur3D"}],
])
@pytest.mark.parametrize("stats", [None, {"mean": 1.5, "std": 0.5, "pmin": 2.0, "pmax": None}])
def test_detect_device_path_equals_jax(raw, stats):
    assert inference_device.detect_device_path(raw, stats) == jax_inference_device.detect_device_path(raw, stats)


@pytest.mark.parametrize("q", [0.0, 1.0, 37.5, 99.6, 100.0])
def test_percentile_is_jnp_percentile(q):
    values = np.random.RandomState(8).rand(1001).astype(np.float32)
    got = _percentile(torch.sort(torch.from_numpy(values)).values, q).item()
    np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(values), q)), rtol=1e-6)


def test_tta_flips_the_port_batch_axes(models):
    # patch axis k is axis k + 2 of (N, C, D, H, W): the z mirror flips dim 2
    sweep = DeviceSlidingWindow(models[2], (8, 16, 16), HALO, tta_axes=(0,))
    assert sweep.tta_combos == [(), (2,)]
    host = StandardPredictor(models[2], None, 2, "cpu", tta=True, tta_axes=[0, 2])
    seen = []
    batch = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(1, 1, 2, 3, 4, 5)[0]
    host._tta_wrap(lambda x: seen.append(x) or x)(batch)
    assert [torch.equal(x, batch.flip(dims)) for x, dims in zip(seen, [(), (2,), (4,), (2, 4)])] == [True] * 4


def test_host_loop_tta_matches_jax(models, tmp_path):
    jax_model, variables, model = models
    batch = np.random.RandomState(9).randn(1, 1, 8, 16, 16).astype(np.float32)
    want = jax_predictor.StandardPredictor(jax_model, variables, None, 2, tta=True)._forward(batch)
    got = StandardPredictor(model, None, 2, "cpu", tta=True)._forward(batch)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_sweep_loop_makes_no_host_sync(models, monkeypatch):
    # inside the patch loop no tensor goes to the host: .item/.cpu/.tolist/.numpy raise there
    sweep = DeviceSlidingWindow(models[2], (8, 16, 16), HALO, normalize="percentile", blend="gaussian",
                                stats={"pmin": 1.0, "pmax": 99.0}, patch_batch=2)
    volume = torch.from_numpy(_volume((12 + 4, 40 + 8, 36 + 8)))
    starts = np.array([[z, y, x] for z in (0, 4) for y in (0, 12, 24) for x in (0, 20)])

    def refuse(*args, **kwargs):
        raise AssertionError("host sync inside the sweep loop")

    accumulate = sweep._accumulate

    def guarded(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in ("item", "cpu", "tolist", "numpy"):
                m.setattr(torch.Tensor, name, refuse)
            return accumulate(*args, **kwargs)

    monkeypatch.setattr(sweep, "_accumulate", guarded)
    out = sweep(volume, starts)
    assert out.shape == (2, 12, 40, 36) and np.isfinite(out).all()


def test_mesh_is_refused_naming_the_roadmap_item(models):
    # "Parallelism" is ported: a mesh is accepted, and one of a single rank
    # sweeps as no mesh does (tests/test_torch_port_parallel.py holds 2 ranks)
    from pytorch3dunet_tpu_torch.parallel.mesh import Mesh

    volume = np.pad(_volume((12, 40, 36)), [(h, h) for h in HALO], mode="reflect")
    starts = np.array([(0, 0, 0), (4, 16, 16), (4, 24, 20)], np.int32)
    plain = DeviceSlidingWindow(models[2], (8, 16, 16), HALO, blend="gaussian")
    one_rank = DeviceSlidingWindow(models[2], (8, 16, 16), HALO, blend="gaussian", mesh=Mesh((0,)),
                                   spatial_mesh=None)
    assert one_rank.mesh is None
    np.testing.assert_array_equal(one_rank(volume, starts), plain(volume, starts))


# --- the H5 path: write-behind, fallback, CLI routing ----------------------------------------------------------
def _h5_config(tmp_path, stems, transformer=None):
    paths = []
    for seed, stem in enumerate(stems):
        path = str(tmp_path / f"{stem}.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("raw", data=_volume((12, 40, 36), seed=10 + seed))
        paths.append(path)
    return {"device": "cpu", "model": dict(MODEL),
            "predictor": {"name": "DeviceSlidingWindowPredictor", "shard": False, "blend": "gaussian"},
            "loaders": {"output_dir": str(tmp_path / "out"), "batch_size": 1, "raw_internal_path": "raw",
                        "num_workers": 1,
                        "test": {"file_paths": paths,
                                 "slice_builder": {"name": "SliceBuilder", "patch_shape": [8, 16, 16],
                                                   "stride_shape": [4, 8, 8], "halo_shape": list(HALO),
                                                   "skip_shape_check": True},
                                 "transformer": {"raw": transformer or [{"name": "Standardize"},
                                                                        {"name": "ToTensor", "expand_dims": True}]}}}}


def _read_outputs(config, stems, out_dir):
    outputs = {}
    for stem in stems:
        with h5py.File(os.path.join(out_dir, f"{stem}_predictions.h5"), "r") as f:
            outputs[stem] = f["predictions"][:]
    return outputs


def test_write_behind_multi_volume_matches_jax(models, tmp_path):
    jax_model, variables, model = models
    stems = ("vol_a", "vol_b")
    config = _h5_config(tmp_path, stems)
    jax_config = dict(config, loaders=dict(config["loaders"], output_dir=str(tmp_path / "jax")))
    os.makedirs(jax_config["loaders"]["output_dir"])
    jax_pred = jax_get_predictor(jax_model, variables, jax_config)
    for loader in jax_get_test_loaders(jax_config):
        jax_pred(loader)
    jax_pred.finalize()
    port = get_predictor(model, config)
    assert isinstance(port, DeviceSlidingWindowPredictor)
    for loader in get_test_loaders(config):
        port(loader)
    assert port._write_future is not None  # the last write is still behind
    port.finalize()
    assert port._writer is None
    got = _read_outputs(config, stems, config["loaders"]["output_dir"])
    want = _read_outputs(config, stems, jax_config["loaders"]["output_dir"])
    for stem in stems:
        np.testing.assert_allclose(got[stem], want[stem], atol=TOL)


def test_write_behind_error_surfaces_on_finalize(models, tmp_path):
    p = DeviceSlidingWindowPredictor(models[2], str(tmp_path), 2, "cpu")

    def failing_save(arr, ds):
        raise RuntimeError("disk full")

    p._save_output = failing_save
    p._submit_write(np.zeros((2, 4, 4, 4), np.float32), None)
    with pytest.raises(RuntimeError, match="disk full"):
        p.finalize()
    p.finalize()  # drained: a second finalize is a no-op


def test_unsupported_pipeline_runs_the_host_loop(models, tmp_path, caplog):
    config = _h5_config(tmp_path, ("vol",), transformer=[{"name": "Normalize", "norm01": True},
                                                          {"name": "ToTensor", "expand_dims": True}])
    config["loaders"]["test"]["slice_builder"]["stride_shape"] = [8, 16, 16]
    port = get_predictor(models[2], config)
    for loader in get_test_loaders(config):
        port(loader)
    port.finalize()
    assert "falling back to the host loop" in caplog.text
    got = _read_outputs(config, ("vol",), config["loaders"]["output_dir"])["vol"]
    config["predictor"] = {"name": "StandardPredictor"}
    config["loaders"]["output_dir"] = str(tmp_path / "host")
    host = get_predictor(models[2], config)
    for loader in get_test_loaders(config):
        host(loader)
    np.testing.assert_array_equal(got, _read_outputs(config, ("vol",), str(tmp_path / "host"))["vol"])


@pytest.mark.parametrize("device,predictor_config,expected", [
    ("cuda", {}, DeviceSlidingWindowPredictor),
    ("cuda:0", {"name": "StandardPredictor"}, DeviceSlidingWindowPredictor),
    (torch.device("cuda"), {"force_host": True}, StandardPredictor),
    ("cpu", {}, StandardPredictor),
    ("cpu", {"name": "DeviceSlidingWindowPredictor", "force_host": True}, DeviceSlidingWindowPredictor),
])
def test_cli_routing(models, tmp_path, device, predictor_config, expected):
    config = {"device": device, "model": dict(MODEL), "predictor": predictor_config,
              "loaders": {"output_dir": str(tmp_path)}}
    assert type(get_predictor(models[2], config)) is expected
