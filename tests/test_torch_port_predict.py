"""The port's prediction path (pytorch3dunet_tpu_torch.predict) against the JAX
package's predict3dunet on the same H5 volume and the same torch-format
checkpoint, plus the port's config and checkpoint handling."""

import os
import subprocess
import sys

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu import predict as jax_predict
from pytorch3dunet_tpu.datasets.utils import get_test_loaders as jax_get_test_loaders
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint
from pytorch3dunet_tpu_torch import predict as port_predict
from pytorch3dunet_tpu_torch.config import load_config, resolve_device
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import get_predictor, run
from pytorch3dunet_tpu_torch.predictor import (DeviceSlidingWindowPredictor, LazyPredictor, StandardPredictor,
                                               evaluate, mean_iou)
from pytorch3dunet_tpu_torch.utils.weights import load_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 8,
         "num_groups": 4, "num_levels": 2, "final_sigmoid": True}
SLICE_BUILDER = {"name": "SliceBuilder", "patch_shape": [8, 64, 64], "stride_shape": [8, 64, 64],
                 "halo_shape": [2, 4, 4]}
TRANSFORMER = {"raw": [{"name": "Standardize"}, {"name": "ToTensor", "expand_dims": True}]}


def _config(tmp, name, output_dir):
    config = {
        "device": "cpu",
        "model_path": os.path.join(tmp, "weights.pytorch"),
        "model": dict(MODEL),
        "predictor": {"name": "StandardPredictor"},
        "loaders": {"dataset": "StandardHDF5Dataset", "output_dir": output_dir, "batch_size": 1,
                    "num_workers": 1, "raw_internal_path": "raw", "global_normalization": True,
                    "test": {"file_paths": [os.path.join(tmp, "test.h5")], "slice_builder": dict(SLICE_BUILDER),
                             "transformer": TRANSFORMER}},
    }
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def _read(path):
    with h5py.File(path, "r") as f:
        return f["predictions"][:]


def _perturbed_variables(model, seed=1):
    """JAX init with non-trivial norm affines (init leaves them 1 / 0)."""
    variables = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rs.rand(*v.shape).astype(np.float32) + 0.5) if path[-1].key == "scale"
        else (rs.rand(*v.shape).astype(np.float32) * 0.4 - 0.2) if path[-1].key == "bias" else np.asarray(v),
        variables)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 16x64x64 volume, a torch-format checkpoint written by the JAX package,
    the JAX predict3dunet output and the port CLI's output (run in a fresh
    interpreter that must not import jax)."""
    tmp = str(tmp_path_factory.mktemp("predict"))
    volume = np.random.RandomState(0).rand(16, 64, 64).astype(np.float32)
    with h5py.File(os.path.join(tmp, "test.h5"), "w") as f:
        f.create_dataset("raw", data=volume)

    variables = _perturbed_variables(jax_get_model(dict(MODEL)))
    save_torch_checkpoint(variables, os.path.join(tmp, "weights.pytorch"))

    jax_yaml, _ = _config(tmp, "jax.yml", os.path.join(tmp, "jax_out"))
    from pytorch3dunet_tpu import predict as jax_predict

    argv = sys.argv
    sys.argv = ["predict3dunet", "--config", jax_yaml]
    try:
        jax_predict.main()
    finally:
        sys.argv = argv

    port_yaml, port_config = _config(tmp, "port.yml", os.path.join(tmp, "port_out"))
    script = ("import runpy, sys\n"
              f"sys.argv = ['predict', '--config', {port_yaml!r}]\n"
              "runpy.run_module('pytorch3dunet_tpu_torch.predict', run_name='__main__')\n"
              "assert 'jax' not in sys.modules, 'the port imported jax'\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'pytorch3dunet_tpu')\n"
              "assert not bad, f'the port imported the JAX package: {bad}'\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=300)
    return {"tmp": tmp, "volume": volume, "port_config": port_config, "proc": proc,
            "jax": _read(os.path.join(tmp, "jax_out", "test_predictions.h5"))}


def test_cli_runs_without_jax(workload):
    proc = workload["proc"]
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_cli_matches_jax_predict3dunet(workload):
    assert workload["proc"].returncode == 0, workload["proc"].stderr[-4000:]
    got = _read(os.path.join(workload["tmp"], "port_out", "test_predictions.h5"))
    assert got.shape == workload["jax"].shape == (1, 16, 64, 64)
    np.testing.assert_allclose(got, workload["jax"], atol=2e-4)


def test_predict_array_equals_h5_path(workload):
    config = dict(workload["port_config"], loaders=dict(workload["port_config"]["loaders"]))
    config["loaders"]["output_dir"] = os.path.join(workload["tmp"], "inproc_out")
    run(config)
    h5 = _read(os.path.join(workload["tmp"], "inproc_out", "test_predictions.h5"))

    model = get_model(MODEL)
    load_weights(model, config["model_path"])
    predictor = StandardPredictor(model.eval(), None, 1, torch.device("cpu"))
    got = predictor.predict_array(workload["volume"], SLICE_BUILDER["patch_shape"], SLICE_BUILDER["stride_shape"],
                                  SLICE_BUILDER["halo_shape"], TRANSFORMER)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, h5)


@pytest.mark.parametrize("option", ["save_segmentation", "prediction_channel"])
def test_saved_outputs(workload, option):
    config = dict(workload["port_config"], loaders=dict(workload["port_config"]["loaders"]))
    out_dir = os.path.join(workload["tmp"], f"{option}_out")
    config["loaders"]["output_dir"] = out_dir
    config["predictor"] = {"name": "StandardPredictor", option: True if option == "save_segmentation" else 0}
    run(config)
    got = _read(os.path.join(out_dir, "test_predictions.h5"))
    probs = workload["jax"]
    if option == "save_segmentation":
        assert got.dtype == np.uint16 and got.shape == probs.shape[1:]
        # voxels within rounding of the 0.5 threshold may fall either way
        decided = np.abs(probs[0] - 0.5) > 1e-3
        np.testing.assert_array_equal(got[decided], (probs[0] > 0.5)[decided])
    else:
        assert got.shape == probs.shape
        np.testing.assert_allclose(got, probs, atol=2e-4)


def test_config_overrides_and_autodetect(tmp_path, monkeypatch):
    # the confocal config has no 'device' key: without a card it raises and
    # names `device: cpu`; with one it takes cuda, in float32
    src = os.path.join(REPO, "resources", "3DUnet_confocal_boundary", "test_config.yml")
    argv = ["--config", src, "--model_path", "w.pytorch", "--loaders.test.slice_builder.patch_shape", "40", "96", "96"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device: cpu"):
        load_config(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    config, path = load_config(argv)
    assert path == src
    assert config["device"] == torch.device("cuda")
    assert torch.backends.cudnn.allow_tf32 is False
    assert config["model_path"] == "w.pytorch"
    assert config["loaders"]["test"]["slice_builder"]["patch_shape"] == [40, 96, 96]
    assert get_model(config["model"]).final_conv.out_channels == 1
    with pytest.raises(ValueError, match="Invalid config key"):
        bad = tmp_path / "bad.yml"
        bad.write_text(yaml.safe_dump({"loaders": {}}))
        load_config(["--config", str(bad), "--model_path", "w.pytorch"])


@pytest.mark.parametrize("value", [None, "cpu", "tpu", "mps"])
def test_resolve_device(value, monkeypatch):
    # without a card only an explicit `device: cpu` runs; the rest raise and name it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if value == "cpu":
        assert resolve_device(value) == torch.device("cpu")
    else:
        with pytest.raises(RuntimeError, match="device: cpu"):
            resolve_device(value)


def test_resolve_device_rejects_unknown():
    with pytest.raises(ValueError, match="not understood"):
        resolve_device("xpu")


# --- performance_metric and LazyPredictor -----------------------------------------------------------------------

# the multiclass recipe (resources/3DUnet_multiclass/test_config.yaml) shrunk: 3 classes, softmax, the argmax saved
MULTICLASS = {**MODEL, "out_channels": 3, "final_sigmoid": False}


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Two 16x64x64 volumes with a class map `label` and a binary `mask`, and
    torch-format checkpoints of a 1-class and a 3-class model."""
    tmp = str(tmp_path_factory.mktemp("scored"))
    rs = np.random.RandomState(2)
    for stem in ("a", "b"):
        with h5py.File(os.path.join(tmp, f"{stem}.h5"), "w") as f:
            f.create_dataset("raw", data=rs.rand(16, 64, 64).astype(np.float32))
            label = np.kron(rs.randint(0, 3, (4, 8, 8)), np.ones((4, 8, 8), dtype=np.int64))
            f.create_dataset("label", data=label)
            f.create_dataset("mask", data=(label > 0).astype(np.uint8))
    for name, model in (("binary", MODEL), ("multiclass", MULTICLASS)):
        save_torch_checkpoint(_perturbed_variables(jax_get_model(dict(model)), seed=3),
                              os.path.join(tmp, f"{name}.pytorch"))
    return tmp


def _scored_config(tmp, model, predictor, out, dataset="StandardHDF5Dataset"):
    name = "multiclass" if model["out_channels"] == 3 else "binary"
    _, config = _config(tmp, f"{out}.yml", os.path.join(tmp, out))
    config.update(model=dict(model), predictor=predictor, model_path=os.path.join(tmp, f"{name}.pytorch"))
    config["loaders"] = dict(config["loaders"], dataset=dataset)
    config["loaders"]["test"] = dict(config["loaders"]["test"],
                                     file_paths=[os.path.join(tmp, f"{stem}.h5") for stem in ("a", "b")])
    path = os.path.join(tmp, f"{out}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path, config


def _jax_run(config):
    """What predict3dunet's main does with `config`, returning the per-volume metrics."""
    model = jax_get_model(dict(config["model"]))
    variables = jax_predict.load_model_variables(model, config["model_path"])
    predictor = jax_predict.get_predictor(model, variables, config)
    metrics = [predictor(loader) for loader in jax_get_test_loaders(config)]
    predictor.finalize()
    return [m for m in metrics if m is not None]


@pytest.mark.parametrize("metric,model,gt", [("dice", MODEL, "mask"), ("mean_iou", MULTICLASS, "label")])
def test_performance_metric_matches_jax_predict3dunet(scored, metric, model, gt):
    predictor = {"name": "StandardPredictor", "save_segmentation": True, "performance_metric": metric,
                 "gt_internal_path": gt}
    path, config = _scored_config(scored, model, predictor, f"port_{metric}")
    got = port_predict.main(["--config", path])
    want = _jax_run(_scored_config(scored, model, predictor, f"jax_{metric}")[1])
    n = 16 if metric == "dice" else 2  # dice of each z-plane of a segmentation; the IoU of classes 1, 2
    assert np.shape(got) == np.shape(want) == (2, n)
    # the segmentations may differ where a probability ties within rounding
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), atol=1e-3)
    with h5py.File(os.path.join(scored, f"port_{metric}", "a_predictions.h5"), "r") as f, \
            h5py.File(os.path.join(scored, "a.h5"), "r") as g:
        np.testing.assert_array_equal(evaluate(f["predictions"][:], g[gt][:], metric, model["out_channels"]), got[0])


def test_mean_iou_of_a_class_absent_from_both_is_nan():
    pred = np.zeros((2, 3, 3), np.uint16)
    gt = np.zeros_like(pred)
    gt[0, 0, 0] = 1
    with np.errstate(invalid="ignore"):
        ious = mean_iou(pred, gt, n_classes=3)
    assert ious[0] == 0 and np.isnan(ious[1])


def test_lazy_predictor_writes_the_standard_and_the_jax_output_in_chunks(scored):
    predictor = {"name": "LazyPredictor"}
    path, config = _scored_config(scored, MODEL, predictor, "port_lazy", dataset="LazyHDF5Dataset")
    assert isinstance(get_predictor(get_model(MODEL), dict(config, device=torch.device("cpu"))), LazyPredictor)
    port_predict.main(["--config", path])
    _jax_run(_scored_config(scored, MODEL, predictor, "jax_lazy", dataset="LazyHDF5Dataset")[1])
    run(_scored_config(scored, MODEL, {"name": "StandardPredictor"}, "port_standard")[1])
    for stem in ("a", "b"):
        with h5py.File(os.path.join(scored, "port_lazy", f"{stem}_predictions.h5"), "r") as f:
            dset = f["predictions"]
            assert dset.chunks is not None and dset.compression == "gzip" and dset.shape == (1, 16, 64, 64)
            lazy = dset[:]
        np.testing.assert_allclose(lazy, _read(os.path.join(scored, "jax_lazy", f"{stem}_predictions.h5")),
                                   atol=2e-4)
        np.testing.assert_array_equal(lazy, _read(os.path.join(scored, "port_standard", f"{stem}_predictions.h5")))


@pytest.mark.parametrize("max_device_voxels", [int(1e9), 2 * 12 * 72 * 72])
def test_device_sweep_with_a_metric_saves_inline_and_scores(scored, max_device_voxels):
    # one-shot, and streamed in z-slabs (the metric read back from the output dataset)
    predictor = {"name": "DeviceSlidingWindowPredictor", "save_segmentation": True, "performance_metric": "mean_iou",
                 "gt_internal_path": "label", "shard": False, "max_device_voxels": max_device_voxels}
    _, config = _scored_config(scored, MULTICLASS, predictor, f"port_sweep_{max_device_voxels}")
    port = get_predictor(get_model(MULTICLASS), dict(config, device=torch.device("cpu")))
    assert isinstance(port, DeviceSlidingWindowPredictor)
    got = run(config)
    assert port.write_behind  # the default stays; the metric saves inline all the same
    want = _jax_run(_scored_config(scored, MULTICLASS, predictor, f"jax_sweep_{max_device_voxels}")[1])
    host = run(_scored_config(scored, MULTICLASS, dict(predictor, name="StandardPredictor"), "port_host_scored")[1])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(host), atol=1e-3)
    for stem, metric in zip(("a", "b"), got):
        with h5py.File(os.path.join(scored, f"port_sweep_{max_device_voxels}", f"{stem}_predictions.h5"), "r") as f, \
                h5py.File(os.path.join(scored, f"{stem}.h5"), "r") as g:
            assert f["predictions"].dtype == np.uint16
            np.testing.assert_array_equal(mean_iou(f["predictions"][:], g["label"][:], 3), metric)
