"""The port's serving artifact (pytorch3dunet_tpu_torch/export.py, a `torch.export`
program whose 3x3x3 convs are calls of the custom op of ops/conv3d.py) against
the JAX package's artifact (pytorch3dunet_tpu/export.py `export_model` with
platforms=("cpu",)) built from the same JAX npz checkpoint: the same raw
patches, made from a numpy seed, go into both. Tolerances: the port's forward
against the JAX forward within 2e-4 (as tests/test_torch_port_model.py: f32
sums in another order); the port's artifact against the port's eager model
within 1e-6 (the same ops; on the CPU the op runs the plain conv).
"""

import json
import zipfile

import jax
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu.export import export_model as jax_export_model
from pytorch3dunet_tpu.export import load_exported as jax_load_exported
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.checkpoint import state_to_bytes
from pytorch3dunet_tpu_torch.export import ServingForward, export_model, load_exported, main
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.ops import conv3d
from pytorch3dunet_tpu_torch.utils.weights import load_weights

TOL = 2e-4
EAGER_TOL = 1e-6
MODEL_2D = {"name": "UNet2D", "in_channels": 1, "out_channels": 2, "f_maps": 4, "layer_order": "gcr",
            "num_groups": 2, "num_levels": 2, "final_sigmoid": True}
MODEL_3D = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 4, "layer_order": "gcr",
            "num_groups": 2, "num_levels": 2, "final_sigmoid": True}
PATCH_2D, PATCH_3D = (16, 16), (8, 8, 8)
STATS = {"mean": 0.4, "std": 1.7, "pmin": 2.0, "pmax": 98.0}


def _checkpoint(path, model_config, seed, ema=False):
    """A JAX npz checkpoint of `model_config` with every leaf drawn from a
    numpy seed (and EMA weights drawn apart when `ema`)."""
    variables = jax.jit(jax_get_model(dict(model_config)).init)(jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(lambda v: (rs.rand(*np.shape(v)) - 0.5).astype(np.float32), variables)
    state = {"model_state_dict": variables, "num_epochs": 1, "num_iterations": 1, "best_eval_score": None}
    if ema:
        state["ema_state_dict"] = jax.tree_util.tree_map(lambda v: v * 0.5 + 0.1, variables["params"])
    path.write_bytes(state_to_bytes(state))
    return str(path)


def _patches(batch, patch, seed):
    return (np.random.RandomState(seed).rand(batch, *patch, 1) * 3 + 1).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts_2d(tmp_path_factory):
    """(port artifact, JAX artifact) of the 2D model with a symbolic batch."""
    tmp = tmp_path_factory.mktemp("export2d")
    ckpt = _checkpoint(tmp / "m2d.ckpt", MODEL_2D, 1)
    jax_export_model({"model": MODEL_2D}, ckpt, str(tmp / "jax.u3dx"), patch_shape=PATCH_2D, batch="poly",
                     platforms=("cpu",))
    meta = export_model({"device": "cpu", "model": MODEL_2D}, ckpt, str(tmp / "port.u3dx"), patch_shape=PATCH_2D,
                        batch="poly")
    assert meta["batch"] == "poly"
    return load_exported(tmp / "port.u3dx"), jax_load_exported(str(tmp / "jax.u3dx")), tmp


def test_2d_symbolic_batch_matches_the_jax_artifact(artifacts_2d):
    port, jax_artifact, _ = artifacts_2d
    assert port.meta["patch_shape"] == list(PATCH_2D)
    for batch in (1, 3):  # traced at 2: the symbolic batch serves any size
        x = _patches(batch, PATCH_2D, batch)
        got = port(x)
        assert got.shape == (batch, *PATCH_2D, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, jax_artifact(x), atol=TOL)


def test_unbatched_call(artifacts_2d):
    port, jax_artifact, _ = artifacts_2d
    x = _patches(1, PATCH_2D, 5)[0]
    single = port(x)
    assert single.shape == (*PATCH_2D, 2)
    np.testing.assert_array_equal(single, port(x[None])[0])
    np.testing.assert_allclose(single, jax_artifact(x), atol=TOL)


@pytest.mark.parametrize("normalize", ["standardize", "standardize_patch", "normalize", "percentile"])
def test_3d_fixed_batch_under_each_normalization(tmp_path, normalize):
    ckpt = _checkpoint(tmp_path / "m3d.ckpt", MODEL_3D, 2)
    stats = {k: v for k, v in STATS.items() if (k in ("mean", "std")) == (normalize == "standardize")}
    jax_export_model({"model": MODEL_3D}, ckpt, str(tmp_path / "jax.u3dx"), patch_shape=PATCH_3D, batch=2,
                     platforms=("cpu",), normalize=normalize, stats=stats)
    export_model({"device": "cpu", "model": MODEL_3D}, ckpt, str(tmp_path / "port.u3dx"), patch_shape=PATCH_3D,
                 batch=2, normalize=normalize, stats=stats)
    port = load_exported(tmp_path / "port.u3dx")
    assert port.meta["normalize"] == normalize and port.meta["batch"] == 2
    # two samples of different ranges: each is normalized by its own statistics
    x = _patches(2, PATCH_3D, 3)
    x[1] = x[1] * 5 - 2
    got = port(x)
    assert got.shape == (2, *PATCH_3D, 1)
    np.testing.assert_allclose(got, jax_load_exported(str(tmp_path / "jax.u3dx"))(x), atol=TOL)


def test_pool_divisibility_refused(tmp_path):
    with pytest.raises(ValueError, match="divisible"):
        export_model({"device": "cpu", "model": dict(MODEL_2D, num_levels=4)}, None, str(tmp_path / "m.u3dx"),
                     patch_shape=(12, 16))


def test_checkpoint_weights_baked_in_ema_preferred(tmp_path):
    ckpt = _checkpoint(tmp_path / "ema.ckpt", MODEL_2D, 4, ema=True)
    jax_export_model({"model": MODEL_2D}, ckpt, str(tmp_path / "jax.u3dx"), patch_shape=PATCH_2D, batch=1,
                     platforms=("cpu",))
    export_model({"device": "cpu", "model": MODEL_2D}, ckpt, str(tmp_path / "port.u3dx"), patch_shape=PATCH_2D,
                 batch=1)
    x = _patches(1, PATCH_2D, 6)
    got = load_exported(tmp_path / "port.u3dx")(x)
    np.testing.assert_allclose(got, jax_load_exported(str(tmp_path / "jax.u3dx"))(x), atol=TOL)
    # the EMA weights, not the raw ones
    raw = get_model(dict(MODEL_2D))
    load_weights(raw, ckpt, ema=False)
    with torch.no_grad():
        raw_probs = raw.eval()(torch.from_numpy(x).movedim(-1, 1))[0].movedim(1, -1).numpy()
    assert np.abs(got - raw_probs).max() > 1e-3


def test_cli_end_to_end(tmp_path, artifacts_2d):
    _, jax_artifact, tmp = artifacts_2d
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.safe_dump({"device": "cpu", "model": MODEL_2D}))
    out = tmp_path / "cli.u3dx"
    main(["--config", str(cfg), "-i", str(tmp / "m2d.ckpt"), "-o", str(out), "--patch-shape", "16", "16",
          "--normalize", "standardize", "--mean", "0.4", "--std", "1.7"])
    with zipfile.ZipFile(out) as z:
        assert sorted(z.namelist()) == ["forward.pt2", "meta.json"]
        meta = json.loads(z.read("meta.json"))
    assert meta["format"] == "pytorch3dunet_tpu_torch.export/1"
    assert meta["model"]["name"] == "UNet2D" and meta["normalize"] == "standardize"
    assert meta["stats"] == {"mean": 0.4, "std": 1.7} and meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert meta["custom_ops"] == ["pytorch3dunet_tpu_torch::conv3d_fwd", "pytorch3dunet_tpu_torch::group_norm_fwd"]
    assert meta["torch_version"] == torch.__version__ and meta["pool_divisibility"] == 2
    x = _patches(2, PATCH_2D, 7)
    # the JAX artifact without normalization, fed the same standardized patch
    np.testing.assert_allclose(load_exported(out)(x), jax_artifact((x - 0.4) / 1.7), atol=TOL)


def test_jax_artifact_refused_with_a_clear_message(artifacts_2d):
    _, _, tmp = artifacts_2d
    with pytest.raises(ValueError, match="JAX"):
        load_exported(tmp / "jax.u3dx")


def test_conv_op_passes_opcheck_on_the_cpu():
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.rand(2, 3, 4, 5, 3).astype(np.float32))
    w = torch.from_numpy(rs.rand(3, 3, 3, 3, 4).astype(np.float32) - 0.5)
    b = torch.from_numpy(rs.rand(4).astype(np.float32))
    for variant in conv3d.KERNELS:
        for dtype in (torch.float32, torch.bfloat16):
            torch.library.opcheck(conv3d.conv3d_op, (x.to(dtype), w.to(dtype), b.to(dtype), variant))
            got = conv3d.conv3d_op(x.to(dtype), w, None, variant)
            torch.testing.assert_close(got, conv3d.conv3d_fwd_reference(x.to(dtype), w), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_artifact_matches_the_eager_model(tmp_path, dtype):
    model_config = {**MODEL_3D, **({"dtype": dtype} if dtype else {})}
    ckpt = _checkpoint(tmp_path / "m3d.ckpt", MODEL_3D, 9)
    meta = export_model({"device": "cpu", "model": model_config}, ckpt, str(tmp_path / "m.u3dx"),
                        patch_shape=PATCH_3D, normalize="standardize_patch")
    assert meta["dtype"] == ("bfloat16" if dtype else "float32")
    port = load_exported(tmp_path / "m.u3dx")
    graph_ops = {str(node.target) for node in port.program.graph.nodes}
    assert "pytorch3dunet_tpu_torch.conv3d_fwd.default" in graph_ops
    model = get_model(model_config)
    load_weights(model, ckpt)
    eager = ServingForward(model.eval(), "standardize_patch")
    x = _patches(3, PATCH_3D, 10)
    with torch.no_grad():
        want = eager(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(port(x), want, rtol=0, atol=EAGER_TOL)


@pytest.mark.parametrize("variant", sorted(conv3d.KERNELS))
def test_conv_op_takes_a_strided_input(variant):
    # the op reads a strided x as its contiguous copy: an exported program
    # keeps no trace-time `.contiguous()` for a run-time input of other strides
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.rand(1, 3, 4, 5, 6).astype(np.float32)).permute(0, 2, 3, 4, 1)
    w = torch.from_numpy(rs.rand(3, 3, 3, 3, 4).astype(np.float32) - 0.5)
    assert not x.is_contiguous()
    got = conv3d.conv3d_op(x, w, None, variant)
    want = conv3d.conv3d_op(x.contiguous(), w, None, variant)
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=EAGER_TOL)


def test_artifact_module_takes_a_strided_input(tmp_path):
    # no normalization baked in and the conv first: the raw input reaches the
    # first conv as it is
    model_config = {**MODEL_3D, "layer_order": "cgr"}
    ckpt = _checkpoint(tmp_path / "m3d.ckpt", model_config, 14)
    export_model({"device": "cpu", "model": model_config}, ckpt, str(tmp_path / "m.u3dx"), patch_shape=PATCH_3D,
                 batch=2)
    port = load_exported(tmp_path / "m.u3dx")
    wide = torch.from_numpy(_patches(2, (8, 8, 16), 15))
    strided = wide[:, :, :, ::2]
    assert not strided.is_contiguous()
    with torch.no_grad():
        got = port.module(strided)
    np.testing.assert_allclose(got.numpy(), port(strided.numpy()), rtol=0, atol=EAGER_TOL)
