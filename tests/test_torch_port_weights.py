"""JAX npz checkpoints in the port (pytorch3dunet_tpu_torch/utils/weights.py
`load_weights`), on checkpoints written by the JAX package's own
`save_checkpoint`: the port reads them with numpy alone and takes the EMA
weights when the checkpoint carries them, as predict3dunet does
(pytorch3dunet_tpu/predict.py `load_model_variables`)."""

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
from pytorch3dunet_tpu.predict import load_model_variables
from pytorch3dunet_tpu.utils.checkpoint import save_checkpoint
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.utils.weights import is_jax_checkpoint, load_weights, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {
    "UNet3D": {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8,
               "num_groups": 4, "num_levels": 2, "final_sigmoid": False},
    "ResidualUNetSE3D": {"name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr",
                         "f_maps": 8, "num_groups": 4, "num_levels": 2},
    "UNet3D-bcr": {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "bcr", "f_maps": 8,
                   "num_levels": 2},
    # 2D leaves: HWIO kernels, BatchNorm batch_stats, the ConvTranspose2d
    "UNet2D-bcr": {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "layer_order": "bcr", "f_maps": 8,
                   "num_levels": 3},
    "ResidualUNet2D": {"name": "ResidualUNet2D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr",
                       "f_maps": 8, "num_groups": 4, "num_levels": 3},
}


def _perturbed(tree, seed):
    """Every leaf of `tree` drawn anew from `seed` (batch stats: var > 0)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda v: (rs.rand(*np.shape(v)) + 0.5).astype(np.float32), tree)


def _write(tmp_path, name, ema):
    """A JAX npz checkpoint of MODELS[name] with random weights (and random
    EMA weights); returns its path."""
    variables = jax_get_model(dict(MODELS[name])).init(jax.random.PRNGKey(0))
    variables = _perturbed(variables, 1)
    state = {"num_epochs": 1, "num_iterations": 5, "model_state_dict": variables, "best_eval_score": 0.5,
             "optimizer_state_dict": None}
    if ema:
        state["ema_state_dict"] = _perturbed(variables["params"], 2)
    out = tmp_path / f"{name}-{ema}"
    save_checkpoint(state, False, str(out))
    return out / "last_checkpoint.pytorch"


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), value.numpy()), key


@pytest.mark.parametrize("name", list(MODELS))
def test_ema_checkpoint_loads_exactly_the_jax_predict_weights(tmp_path, name):
    path = _write(tmp_path, name, ema=True)
    assert is_jax_checkpoint(path)
    model = get_model(dict(MODELS[name]))
    load_weights(model, path)
    want = state_dict_from_jax(load_model_variables(jax_get_model(dict(MODELS[name])), str(path)))
    _assert_state_equal(model.state_dict(), want)


def test_checkpoint_without_ema_loads_model_state_dict(tmp_path):
    path = _write(tmp_path, "UNet3D", ema=False)
    from pytorch3dunet_tpu.utils.checkpoint import load_checkpoint

    template = jax_get_model(dict(MODELS["UNet3D"])).init(jax.random.PRNGKey(0))
    raw = load_checkpoint(str(path), template)["model_state_dict"]
    model = get_model(dict(MODELS["UNet3D"]))
    load_weights(model, path)
    _assert_state_equal(model.state_dict(), state_dict_from_jax(raw))


def test_checkpoint_of_another_architecture_names_the_leaf(tmp_path):
    path = _write(tmp_path, "UNet3D", ema=True)
    wider = get_model({**MODELS["UNet3D"], "f_maps": 16})
    with pytest.raises(ValueError, match=r"leaf params/decoder0/basic_module/SingleConv1/conv/kernel has shape"):
        load_weights(wider, path)
    other = get_model(dict(MODELS["ResidualUNetSE3D"]))
    with pytest.raises(ValueError, match="model_state_dict has .* leaves but the model has"):
        load_weights(other, path)


def test_other_files_pass(tmp_path):
    text = tmp_path / "notes.txt"
    text.write_text("not a zip")
    assert not is_jax_checkpoint(text)
    path = tmp_path / "w.pytorch"
    model = get_model(dict(MODELS["UNet3D"]))
    torch.save({"model_state_dict": model.state_dict()}, path)
    assert not is_jax_checkpoint(path)
    fresh = get_model(dict(MODELS["UNet3D"]))
    load_weights(fresh, path)
    _assert_state_equal(fresh.state_dict(), model.state_dict())


def test_predict_cli_on_a_jax_checkpoint_matches_predict3dunet(tmp_path):
    # the EMA checkpoint through both CLIs: the port's in a fresh interpreter
    # that must not import jax
    path = _write(tmp_path, "UNet3D", ema=True)
    volume = np.random.RandomState(0).rand(16, 64, 64).astype(np.float32)
    with h5py.File(tmp_path / "test.h5", "w") as f:
        f.create_dataset("raw", data=volume)

    def config(name):
        cfg = {"device": "cpu", "model_path": str(path), "model": dict(MODELS["UNet3D"]),
               "loaders": {"dataset": "StandardHDF5Dataset", "output_dir": str(tmp_path / name), "batch_size": 1,
                           "num_workers": 1, "raw_internal_path": "raw", "global_normalization": True,
                           "test": {"file_paths": [str(tmp_path / "test.h5")],
                                    "slice_builder": {"name": "SliceBuilder", "patch_shape": [8, 64, 64],
                                                      "stride_shape": [8, 64, 64], "halo_shape": [2, 4, 4]},
                                    "transformer": {"raw": [{"name": "Standardize"},
                                                            {"name": "ToTensor", "expand_dims": True}]}}}}
        out = tmp_path / f"{name}.yml"
        out.write_text(yaml.safe_dump(cfg))
        return str(out)

    from pytorch3dunet_tpu import predict as jax_predict

    argv = sys.argv
    sys.argv = ["predict3dunet", "--config", config("jax")]
    try:
        jax_predict.main()
    finally:
        sys.argv = argv
    script = ("import runpy, sys\n"
              f"sys.argv = ['predict', '--config', {config('port')!r}]\n"
              "runpy.run_module('pytorch3dunet_tpu_torch.predict', run_name='__main__')\n"
              "assert 'jax' not in sys.modules, 'the port imported jax'\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "EMA weights" in proc.stdout + proc.stderr
    results = []
    for name in ("jax", "port"):
        with h5py.File(tmp_path / name / "test_predictions.h5", "r") as f:
            results.append(f["predictions"][:])
    assert results[0].shape == results[1].shape == (2, 16, 64, 64)
    np.testing.assert_allclose(results[1], results[0], atol=2e-4)
