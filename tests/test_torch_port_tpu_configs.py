"""The five `_tpu` prediction configs of resources/ through the port's predict
CLI (`run`), against predict3dunet on the same volume and the same JAX npz
checkpoint, at a tiny width and patch on the CPU.

Each names `DeviceSlidingWindowPredictor`; four set `model.dtype: bfloat16`.
The f32 config matches to 2e-4. The bf16 configs run with the port's plain conv
rounded as the JAX model's conv (`jax_conv_rounding`, see
tests/test_torch_port_bf16.py) and match to 2e-2.
"""

import os
import sys

import h5py
import jax
import numpy as np
import pytest
import yaml
from test_torch_port_bf16 import BF16_TOL, _perturbed_norms, jax_conv_rounding  # noqa: F401 (a fixture)

from pytorch3dunet_tpu import predict as jax_predict
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.checkpoint import save_checkpoint
from pytorch3dunet_tpu_torch.models.unet import compute_dtype
from pytorch3dunet_tpu_torch.predict import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-4

TPU_CONFIGS = {
    "confocal_boundary": "3DUnet_confocal_boundary_tpu/test_config.yml",
    "lightsheet_boundary": "3DUnet_lightsheet_boundary_tpu/test_config.yml",
    "lightsheet_nuclei": "3DUnet_lightsheet_nuclei_tpu/test_config.yaml",
    "multiclass": "3DUnet_multiclass_tpu/test_config.yaml",
    "denoising": "3DUnet_denoising_tpu/test_config_regression.yaml",
}
VOLUME = (16, 64, 64)


def _shrunk(config: dict, tmp, name) -> dict:
    """The config at a tiny width and patch, on the CPU, with this test's
    files: f_maps 8 (a list keeps its length, halved down to 8 then doubling),
    num_groups 4, 2 levels; patch, stride and halo divided by 8 in z and by
    ~4 in y and x (a stride that overlaps keeps overlapping)."""
    config = dict(config, device="cpu", model_path=os.path.join(tmp, "checkpoint", "last_checkpoint.pytorch"))
    model = dict(config["model"], f_maps=8, num_groups=4, num_levels=2)
    config["model"] = model
    test = dict(config["loaders"]["test"], file_paths=[os.path.join(tmp, "volume.h5")])
    sb = test["slice_builder"]

    def shrink(shape, dz, dyx):
        return [max(1, shape[0] // dz), max(1, shape[1] // dyx), max(1, shape[2] // dyx)]

    overlapping = sb["stride_shape"] != sb["patch_shape"]
    patch = [8, 32, 32]
    stride = [4, 16, 16] if overlapping else patch
    test["slice_builder"] = dict(sb, patch_shape=patch, stride_shape=stride, halo_shape=shrink(sb["halo_shape"], 8, 8),
                                 skip_shape_check=True)
    # the JAX package shards the grid over the tests' 8 virtual CPU devices
    # unless told not to; the port runs on one device
    config["predictor"] = dict(config["predictor"], shard=False)
    config["loaders"] = dict(config["loaders"], output_dir=os.path.join(tmp, name), num_workers=1, test=test)
    return config


@pytest.mark.parametrize("name", list(TPU_CONFIGS))
def test_tpu_config_matches_predict3dunet(tmp_path, name, jax_conv_rounding):
    with open(os.path.join(REPO, "resources", TPU_CONFIGS[name])) as f:
        config = _shrunk(yaml.safe_load(f), str(tmp_path), name)
    assert config["predictor"]["name"] == "DeviceSlidingWindowPredictor"
    with h5py.File(tmp_path / "volume.h5", "w") as f:
        f.create_dataset("raw", data=np.random.RandomState(0).rand(*VOLUME).astype(np.float32))
    # a JAX npz checkpoint with perturbed norm affines, read by both CLIs
    variables = _perturbed_norms(jax_get_model(dict(config["model"])).init(jax.random.PRNGKey(0)))
    save_checkpoint({"num_epochs": 1, "num_iterations": 1, "model_state_dict": variables, "best_eval_score": 0.0,
                     "optimizer_state_dict": None}, False, str(tmp_path / "checkpoint"))

    jax_config = dict(config, loaders=dict(config["loaders"], output_dir=str(tmp_path / "jax")))
    path = tmp_path / "jax.yml"
    path.write_text(yaml.safe_dump(jax_config))
    argv = sys.argv
    sys.argv = ["predict3dunet", "--config", str(path)]
    try:
        jax_predict.main()
    finally:
        sys.argv = argv
    run(config)

    results = []
    for out in ("jax", name):
        with h5py.File(tmp_path / out / "volume_predictions.h5", "r") as f:
            results.append(f["predictions"][:])
    want, got = results
    assert got.shape == want.shape == (config["model"]["out_channels"], *VOLUME)
    assert np.isfinite(got).all()
    bf16 = compute_dtype(config["model"].get("dtype")) is not None
    np.testing.assert_allclose(got, want, atol=BF16_TOL if bf16 else F32_TOL)
