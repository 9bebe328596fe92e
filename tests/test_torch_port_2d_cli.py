"""The 2D confocal configs (resources/2DUnet_confocal_boundary) shrunk,
through the port's CLIs against `predict3dunet` and `train3dunet` on the CPU:
prediction with depth-1 patches and an xy halo, the device predictor's host
fallback for deeper patches, and training from the same weights.
"""

import logging
import os
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu import predict as jax_predict
from pytorch3dunet_tpu import predictor as jax_predictor
from pytorch3dunet_tpu import train as jax_train
from pytorch3dunet_tpu.augment.transforms import StandardLabelToBoundary
from pytorch3dunet_tpu.datasets.utils import get_test_loaders as jax_get_test_loaders
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint
from pytorch3dunet_tpu_torch import predict as port_predict
from pytorch3dunet_tpu_torch import train as port_train
from pytorch3dunet_tpu_torch.datasets.utils import get_test_loaders
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.utils.weights import load_weights
from tests.test_torch_port_2d import TOL, _jax, _port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFOCAL_2D = os.path.join(REPO, "resources", "2DUnet_confocal_boundary")


def _write(path, seed, shape):
    rs = np.random.RandomState(seed)
    cells = rs.randint(1, 20, (shape[0], -(-shape[1] // 8), -(-shape[2] // 8)))
    label = np.kron(cells, np.ones((1, 8, 8), dtype=np.int64))[:, :shape[1], :shape[2]]
    raw = StandardLabelToBoundary()(label)[0] + 0.5 * rs.rand(*shape)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw.astype(np.float32))
        f.create_dataset("label", data=label)


def _shrunk(name, tmp, **loaders):
    with open(os.path.join(CONFOCAL_2D, name)) as f:
        config = yaml.safe_load(f)
    config["device"] = "cpu"
    config["model"].update(f_maps=8, num_groups=4, num_levels=2)
    config["loaders"].update(num_workers=1, **loaders)
    return config


def _run_jax_cli(module, config, path):
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    argv = sys.argv
    sys.argv = ["cli", "--config", path]
    try:
        module.main()
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A torch-format checkpoint of the shrunk 2D confocal model, written by
    the JAX package, and its folder."""
    tmp = str(tmp_path_factory.mktemp("confocal2d"))
    cfg = _shrunk("test_config.yml", tmp)["model"]
    _, variables = _jax(cfg, seed=4)
    save_torch_checkpoint(variables, os.path.join(tmp, "weights.pytorch"))
    return tmp


def test_predict_cli_matches_predict3dunet(checkpoint, tmp_path):
    """The shrunk 2D confocal test config: depth-1 patches with a 0 x 8 x 8
    halo, the host loop, the port CLI against predict3dunet."""
    _write(tmp_path / "test.h5", 0, (3, 100, 90))
    outputs = {}
    for side, run in (("jax", lambda c, p: _run_jax_cli(jax_predict, c, p)),
                      ("port", lambda c, p: port_predict.run(c))):
        config = _shrunk("test_config.yml", checkpoint)
        config["model_path"] = os.path.join(checkpoint, "weights.pytorch")
        config["loaders"]["output_dir"] = str(tmp_path / side)
        config["loaders"]["test"].update(file_paths=[str(tmp_path / "test.h5")])
        config["loaders"]["test"]["slice_builder"].update(patch_shape=[1, 64, 64], stride_shape=[1, 64, 64],
                                                          halo_shape=[0, 8, 8])
        run(config, str(tmp_path / f"{side}.yml"))
        with h5py.File(tmp_path / side / "test_predictions.h5", "r") as f:
            outputs[side] = f["predictions"][:]
    assert outputs["port"].shape == (1, 3, 100, 90)
    np.testing.assert_allclose(outputs["port"], outputs["jax"], rtol=0, atol=TOL)


def test_deeper_patches_fall_back_to_the_host_loop_as_jax(checkpoint, tmp_path, caplog):
    """A 2D model with patches deeper than 1 leaves the device sweep for the
    host loop with a warning, in both packages; the host loop then refuses
    the batch (JAX: np.squeeze of a non-singleton z)."""
    _write(tmp_path / "test.h5", 0, (4, 64, 64))
    config = _shrunk("test_config.yml", checkpoint)
    config["loaders"]["test"].update(file_paths=[str(tmp_path / "test.h5")])
    config["loaders"]["test"]["slice_builder"].update(patch_shape=[2, 64, 64], stride_shape=[2, 64, 64],
                                                      halo_shape=[0, 0, 0])
    config["loaders"]["output_dir"] = str(tmp_path)
    jax_model, variables = _jax(config["model"], seed=4)
    model = _port(config["model"], variables).eval()
    port = DeviceSlidingWindowPredictor(model, str(tmp_path), 1, "cpu")
    with caplog.at_level(logging.WARNING), pytest.raises(ValueError, match="depth 1"):
        port(next(get_test_loaders(config)))
    assert any("falling back to the host loop" in r.getMessage() for r in caplog.records)
    want = jax_predictor.DeviceSlidingWindowPredictor(jax_model, variables, str(tmp_path), 1, shard=False)
    with pytest.raises(ValueError):
        want(next(jax_get_test_loaders(config)))


def test_train_cli_matches_train3dunet(checkpoint, tmp_path):
    """The shrunk 2D confocal train config through both CLIs from the same
    weights (`pre_trained`), SGD and no random transforms: one batch holds
    both patches of the volume, so the shuffle cannot part them. After 3
    iterations and a validation the port's checkpoint holds the JAX run's
    weights within 1e-5 of their largest."""
    _write(tmp_path / "train.h5", 1, (2, 64, 64))
    _write(tmp_path / "val.h5", 2, (1, 64, 64))
    states = {}
    for side in ("jax", "port"):
        config = _shrunk("train_config.yml", checkpoint, batch_size=2)
        config["optimizer"] = {"name": "SGD", "learning_rate": 0.05}
        config["trainer"].update(checkpoint_dir=str(tmp_path / side), pre_trained=os.path.join(checkpoint,
                                 "weights.pytorch"), validate_after_iters=2, log_after_iters=2, max_num_iterations=2)
        config["trainer"].pop("tensorboard_formatter")
        for phase, volume in (("train", "train.h5"), ("val", "val.h5")):
            config["loaders"][phase].update(file_paths=[str(tmp_path / volume)])
            config["loaders"][phase]["slice_builder"].update(name="SliceBuilder", patch_shape=[1, 64, 64],
                                                             stride_shape=[1, 64, 64])
            config["loaders"][phase]["transformer"]["raw"] = [{"name": "Standardize"},
                                                              {"name": "ToTensor", "expand_dims": True}]
            config["loaders"][phase]["transformer"]["label"] = [
                {"name": "StandardLabelToBoundary", "append_label": True}, {"name": "ToTensor", "expand_dims": False}]
        if side == "jax":
            _run_jax_cli(jax_train, config, str(tmp_path / "jax.yml"))
        else:
            with open(tmp_path / "port.yml", "w") as f:
                yaml.safe_dump(config, f)
            port_train.main(["--config", str(tmp_path / "port.yml")])
        model = get_model(config["model"])
        load_weights(model, tmp_path / side / "last_checkpoint.pytorch")
        states[side] = model.state_dict()
    start = torch.load(os.path.join(checkpoint, "weights.pytorch"), weights_only=True)
    start = start.get("model_state_dict", start)
    w_max = max(v.abs().max().item() for v in states["jax"].values())
    for key, want in states["jax"].items():
        torch.testing.assert_close(states["port"][key], want, rtol=0, atol=1e-5 * w_max, msg=key)
    assert any(not torch.equal(states["port"][k], start[k].float()) for k in start)
