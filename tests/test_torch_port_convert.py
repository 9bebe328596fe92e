"""The port's checkpoint conversion (pytorch3dunet_tpu_torch/convert.py and the npz
writer `utils/weights.py` `jax_checkpoint_bytes`) against the JAX package's
`convert3dunet` and `load_checkpoint`: the same seeded weights (JAX variables
drawn from numpy, crossed with the export), exact equality throughout (the
conversions only transpose and flip).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu.convert import convert_checkpoint as jax_convert_checkpoint
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from pytorch3dunet_tpu.utils.checkpoint import state_to_bytes
from pytorch3dunet_tpu_torch.convert import convert_checkpoint, main
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.utils.weights import (is_jax_checkpoint, jax_checkpoint_bytes, read_jax_checkpoint,
                                                   state_dict_from_jax)

MODELS = {
    "UNet3D-gcr": {"name": "UNet3D", "in_channels": 1, "out_channels": 2, "layer_order": "gcr", "f_maps": 8,
                   "num_groups": 4, "num_levels": 2, "final_sigmoid": False},
    # BatchNorm: batch_stats leaves ahead of the params
    "UNet2D-bcr": {"name": "UNet2D", "in_channels": 1, "out_channels": 1, "layer_order": "bcr", "f_maps": 8,
                   "num_levels": 2},
    # ResNet blocks, the SE layers' dense kernels and the deconv's flipped taps
    "ResidualUNetSE3D": {"name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr",
                         "f_maps": 8, "num_groups": 4, "num_levels": 2},
}
_variables_cache: dict = {}


def _variables(name):
    """The JAX variables of MODELS[name], every leaf drawn from a numpy seed
    (batch stats > 0), and the template that JAX `load_checkpoint` restores
    against."""
    if name not in _variables_cache:
        template = jax.jit(jax_get_model(dict(MODELS[name])).init)(jax.random.PRNGKey(0))
        rs = np.random.RandomState(sorted(MODELS).index(name))
        variables = jax.tree_util.tree_map(lambda v: (rs.rand(*np.shape(v)) + 0.5).astype(np.float32), template)
        _variables_cache[name] = variables, template
    return _variables_cache[name]


def _write_npz(path, variables, **extra):
    state = {"model_state_dict": variables, "num_epochs": 3, "num_iterations": 42, "best_eval_score": 0.5, **extra}
    with open(path, "wb") as f:
        f.write(state_to_bytes(state))
    return str(path)


def _assert_leaves_equal(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _assert_state_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_npz_to_torch_loads_strictly_and_equals_the_jax_variables(tmp_path, name):
    variables, template = _variables(name)
    npz = _write_npz(tmp_path / "native.ckpt", variables)
    out = str(tmp_path / "converted.pytorch")
    assert convert_checkpoint({"model": MODELS[name]}, npz, out) == "torch"
    state = torch.load(out, weights_only=True)["model_state_dict"]
    _assert_state_equal(state, state_dict_from_jax(variables))
    get_model(dict(MODELS[name])).load_state_dict(state, strict=True)
    # and the JAX package reads it back as its own variables
    _assert_leaves_equal(jax_load_checkpoint(out, template)["model_state_dict"], variables)


@pytest.mark.parametrize("name", list(MODELS))
def test_torch_to_native_loads_in_jax_with_every_leaf_exact(tmp_path, name):
    variables, template = _variables(name)
    torch_path = tmp_path / "port.pytorch"
    torch.save({"model_state_dict": state_dict_from_jax(variables)}, torch_path)
    out = str(tmp_path / "native.ckpt")
    assert convert_checkpoint({"model": MODELS[name]}, torch_path, out) == "native"
    assert is_jax_checkpoint(out)
    state = jax_load_checkpoint(out, template)
    _assert_leaves_equal(state["model_state_dict"], variables)
    # a fresh start, as the JAX tool writes it
    assert (state["num_epochs"], state["num_iterations"], state["best_eval_score"]) == (0, 1, None)
    # leaf for leaf the JAX tool's own conversion
    jax_out = str(tmp_path / "jax_native.ckpt")
    jax_convert_checkpoint({"model": MODELS[name]}, str(torch_path), jax_out)
    ours, theirs = read_jax_checkpoint(out), read_jax_checkpoint(jax_out)
    assert set(ours) == set(theirs)
    assert all(np.array_equal(a, b) for a, b in zip(ours["model_state_dict"], theirs["model_state_dict"]))


def test_round_trip_is_bitwise(tmp_path):
    variables, _ = _variables("ResidualUNetSE3D")
    config = {"model": MODELS["ResidualUNetSE3D"]}
    npz = _write_npz(tmp_path / "a.ckpt", variables)
    assert convert_checkpoint(config, npz, tmp_path / "b.pytorch") == "torch"
    assert convert_checkpoint(config, tmp_path / "b.pytorch", tmp_path / "c.ckpt") == "native"
    assert convert_checkpoint(config, tmp_path / "c.ckpt", tmp_path / "d.pytorch") == "torch"
    first, again = read_jax_checkpoint(npz), read_jax_checkpoint(tmp_path / "c.ckpt")
    assert len(first["model_state_dict"]) == len(again["model_state_dict"])
    for a, b in zip(first["model_state_dict"], again["model_state_dict"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _assert_state_equal(torch.load(tmp_path / "d.pytorch", weights_only=True)["model_state_dict"],
                        torch.load(tmp_path / "b.pytorch", weights_only=True)["model_state_dict"])


def test_native_to_native_keeps_the_other_entries(tmp_path):
    variables, template = _variables("UNet3D-gcr")
    ema = [leaf * 2 for leaf in jax.tree_util.tree_leaves(variables["params"])]
    npz = _write_npz(tmp_path / "a.ckpt", variables, ema_state_dict=ema)
    assert convert_checkpoint({"model": MODELS["UNet3D-gcr"]}, npz, tmp_path / "b.ckpt", to="native") == "native"
    got, want = read_jax_checkpoint(tmp_path / "b.ckpt"), read_jax_checkpoint(npz)
    assert set(got) == set(want)
    assert (got["num_epochs"], got["num_iterations"], got["best_eval_score"]) == (3, 42, 0.5)
    for key in ("model_state_dict", "ema_state_dict"):
        assert all(np.array_equal(a, b) for a, b in zip(got[key], want[key]))


@pytest.mark.parametrize("source", ["native", "torch"])
def test_wrong_architecture_raises_naming_the_shape(tmp_path, source):
    variables, _ = _variables("UNet3D-gcr")
    path = _write_npz(tmp_path / "native.ckpt", variables)
    if source == "torch":
        path = str(tmp_path / "t.pytorch")
        torch.save({"model_state_dict": state_dict_from_jax(variables)}, path)
    bad = {"model": dict(MODELS["UNet3D-gcr"], f_maps=16)}
    with pytest.raises(ValueError, match="shape"):
        convert_checkpoint(bad, path, str(tmp_path / "x.out"))


def test_missing_model_section_raises(tmp_path):
    with pytest.raises(ValueError, match="'model' section"):
        convert_checkpoint({}, str(tmp_path / "in"), str(tmp_path / "out"))


def test_cli_with_a_yaml_config(tmp_path):
    variables, template = _variables("UNet2D-bcr")
    npz = _write_npz(tmp_path / "native.ckpt", variables)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump({"model": MODELS["UNet2D-bcr"]}))
    out = str(tmp_path / "out.pytorch")
    assert main(["--config", str(cfg), "-i", npz, "-o", out, "--to", "torch"]) == "torch"
    assert os.path.exists(out) and not is_jax_checkpoint(out)
    _assert_leaves_equal(jax_load_checkpoint(out, template)["model_state_dict"], variables)


@pytest.mark.parametrize("source", ["native", "torch"])
def test_ema_checkpoint_converts_its_raw_weights(tmp_path, source):
    # as the JAX tool does: model_state_dict, never ema_state_dict
    variables, template = _variables("UNet3D-gcr")
    ema_tree = jax.tree_util.tree_map(lambda v: v * 2, variables["params"])
    config = {"model": MODELS["UNet3D-gcr"]}
    if source == "native":
        path = _write_npz(tmp_path / "ema.ckpt", variables, ema_state_dict=ema_tree)
        out, jax_out = str(tmp_path / "out.pytorch"), str(tmp_path / "jax_out.pytorch")
        jax_convert_checkpoint(config, path, jax_out)
        convert_checkpoint(config, path, out)
        got = torch.load(out, weights_only=True)["model_state_dict"]
        _assert_state_equal(got, torch.load(jax_out, weights_only=True)["model_state_dict"])
        _assert_state_equal(got, state_dict_from_jax(variables))
    else:
        path = str(tmp_path / "ema.pytorch")
        ema = state_dict_from_jax({"params": ema_tree})
        torch.save({"model_state_dict": state_dict_from_jax(variables), "ema_state_dict": ema}, path)
        out = str(tmp_path / "out.ckpt")
        convert_checkpoint(config, path, out)
        _assert_leaves_equal(jax_load_checkpoint(out, template)["model_state_dict"], variables)


def test_npz_writer_is_the_jax_layout(tmp_path):
    # the same leaves, metadata and entry names as JAX `state_to_bytes`
    variables, _ = _variables("UNet2D-bcr")
    state = {"num_epochs": 1, "num_iterations": 7, "best_eval_score": None, "optimizer_state_dict": None}
    ours = tmp_path / "ours.ckpt"
    ours.write_bytes(jax_checkpoint_bytes({"model_state_dict": state_dict_from_jax(variables), **state}))
    theirs = _write_npz(tmp_path / "theirs.ckpt", variables, **state)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            assert np.array_equal(a[key], b[key]), key
