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

from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint
from pytorch3dunet_tpu_torch.config import load_config, resolve_device
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import get_predictor, run
from pytorch3dunet_tpu_torch.predictor import StandardPredictor
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


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 16x64x64 volume, a torch-format checkpoint written by the JAX package,
    the JAX predict3dunet output and the port CLI's output (run in a fresh
    interpreter that must not import jax)."""
    tmp = str(tmp_path_factory.mktemp("predict"))
    volume = np.random.RandomState(0).rand(16, 64, 64).astype(np.float32)
    with h5py.File(os.path.join(tmp, "test.h5"), "w") as f:
        f.create_dataset("raw", data=volume)

    model = jax_get_model(dict(MODEL))
    variables = model.init(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    # non-trivial norm affines (init leaves them 1 / 0)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, v: (rs.rand(*v.shape).astype(np.float32) + 0.5) if path[-1].key == "scale"
        else (rs.rand(*v.shape).astype(np.float32) * 0.4 - 0.2) if path[-1].key == "bias" else np.asarray(v),
        variables)
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


def test_unported_predictors_raise(tmp_path):
    config = {"loaders": {"output_dir": str(tmp_path)}, "model": MODEL, "device": torch.device("cpu"),
              "predictor": {"name": "LazyPredictor"}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_predictor(None, config)
