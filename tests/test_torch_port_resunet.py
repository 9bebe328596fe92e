"""The port's ResidualUNet3D and ResidualUNetSE3D against the JAX package's, on
the CPU: forwards with and without P3DUNET_TAPFOLD=1, the conv variant each
layer asks for, one step's gradients, state dicts, and the predict CLI.

Weights start from the port's own init with random GroupNorm affines, cross to
the JAX package through its torch interop, and come back into a fresh port
model through `state_dict_from_jax`. The JAX side runs under `jax.jit`. On the
CPU every port conv runs its plain version; the CUDA kernels are held against it
on the GPU by chip_smoke.py.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint, torch_state_dict_to_params
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models import blocks, se
from pytorch3dunet_tpu_torch.models.unet import ResidualUNet3D, ResidualUNetSE3D, get_model
from pytorch3dunet_tpu_torch.ops import conv3d, upconv
from pytorch3dunet_tpu_torch.utils.weights import load_weights, state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f_maps 16 over 3 levels gives F = 16, 32, 64: both sides of the K1 switch;
# num_groups 4 (at 2 the JAX package's own f32 grads drift, ROADMAP Queue 3)
BASE = {"in_channels": 1, "out_channels": 1, "f_maps": 16, "num_groups": 4, "num_levels": 3,
        "final_sigmoid": True}
FAMILIES = ["ResidualUNet3D", "ResidualUNetSE3D"]
# exact 2x at every level (8 -> 4 -> 2), and odd sizes whose deconv output
# (2n - 1) needs the nearest fix-up to the skip's size
SHAPES = {"exact": (8, 16, 16), "odd": (10, 14, 18)}
LOSS = {"name": "BCEDiceLoss", "ignore_index": None, "skip_last_target": True}
FORWARD_TOL = 2e-4


def _cfg(name, order="gcr"):
    return {"name": name, "layer_order": order, **BASE}


def _port_state(name, seed):
    """A port model's state dict: torch's init, GroupNorm affines random."""
    torch.manual_seed(seed)
    model = get_model(_cfg(name))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.GroupNorm):
                module.weight.copy_(torch.rand(module.weight.shape, generator=gen) + 0.5)
                module.bias.copy_(torch.rand(module.bias.shape, generator=gen) * 0.4 - 0.2)
    return model.state_dict()


@pytest.fixture(scope="module")
def variables():
    """The JAX variables of each family, made from the port's weights."""
    return {name: {"params": torch_state_dict_to_params({k: v.numpy() for k, v in _port_state(name, i).items()})}
            for i, name in enumerate(FAMILIES)}


def _port_model(name, variables, order="gcr"):
    model = get_model(_cfg(name, order))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _jax_forward(name, order, variables, x):
    model = jax_get_model(_cfg(name, order))
    return jax.jit(lambda v, x_: model.apply(v, x_))(variables, jnp.asarray(x))


def _input(shape, seed=5):
    return np.random.RandomState(seed).rand(1, *shape, 1).astype(np.float32)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("order", ["gcr", "gce"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(variables, name, order, shape):
    x = _input(SHAPES[shape])
    want_probs, want_logits = _jax_forward(name, order, variables[name], x)
    model = _port_model(name, variables[name], order).eval()
    with torch.inference_mode():
        probs, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want_logits), -1, 1), atol=FORWARD_TOL)
    np.testing.assert_allclose(probs.numpy(), np.moveaxis(np.asarray(want_probs), -1, 1), atol=FORWARD_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax_with_tapfold(variables, name, monkeypatch):
    # the JAX package reads the switch while it traces, the port at every conv
    monkeypatch.setenv("P3DUNET_TAPFOLD", "1")
    x = _input(SHAPES["odd"], seed=6)
    _, want = _jax_forward(name, "gcr", variables[name], x)
    model = _port_model(name, variables[name]).eval()
    with torch.inference_mode():
        _, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=FORWARD_TOL)


def _recorded_variants(model, x, monkeypatch, grad):
    calls = []
    real = conv3d.conv3d_fwd

    def spy(x_, w, b=None, variant=None):
        # None is the forward's own choice, which conv3d_fwd resolves so
        calls.append((w.shape[-1], variant or conv3d.forward_variant(w.shape[-1])))
        return real(x_, w, b, variant=variant)

    monkeypatch.setattr(conv3d, "conv3d_fwd", spy)
    if grad:
        model(x.requires_grad_())[1].sum().backward()
    else:
        with torch.no_grad():
            model(x)
    return calls


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "train"])
@pytest.mark.parametrize("tapfold", ["0", "1", None])
def test_conv_variant_follows_features_and_switch(monkeypatch, tapfold, grad):
    if tapfold is None:
        monkeypatch.delenv("P3DUNET_TAPFOLD", raising=False)
    else:
        monkeypatch.setenv("P3DUNET_TAPFOLD", tapfold)
    model = get_model(_cfg("ResidualUNet3D")).train(grad)
    calls = _recorded_variants(model, torch.rand(1, 1, *SHAPES["exact"]), monkeypatch, grad)
    forwards = [c for c in calls if c[1] != "packw"]
    # 3 levels: encoders 16, 32, 64 and decoders 32, 16, two 3x3x3 convs each;
    # before each decoder's, its phase deconv (P3DUNET_DECONV=phase, the
    # default): one conv with F = 8 Co, pinned to K2 whatever the switch
    phase = upconv.deconv_mode() == "phase"
    deconvs = {6: 8 * 32, 9: 8 * 16} if phase else {}
    convs = [16, 16, 32, 32, 64, 64, 32, 32, 16, 16]
    for position in sorted(deconvs):
        convs.insert(position, deconvs[position])
    assert [f for f, _ in forwards] == convs
    for position, (features, variant) in enumerate(forwards):
        pinned = position in deconvs
        assert variant == ("im2col" if tapfold == "1" and features >= 64 and not pinned else "roll")
    # the input gradient stays on K3 for every conv, whatever the switch
    assert [v for _, v in calls if v == "packw"] == (["packw"] * len(convs) if grad else [])


def test_model_counts_of_the_lightsheet_model():
    """The ResidualUNet3D of resources/3DUnet_lightsheet_boundary: 18 3x3x3
    convs with C = F, 14 of them with F >= 64 (K1 under the switch); 1x1
    projections only where an encoder changes the channel count."""
    model = ResidualUNet3D(in_channels=1, out_channels=1, f_maps=32, num_groups=8)
    convs = [(m.in_channels, m.out_channels) for m in model.modules()
             if isinstance(m, conv3d.Conv3d) and m.kernel_size == (3, 3, 3)]
    assert len(convs) == 18 and all(c == f for c, f in convs)
    assert sum(f >= 64 for _, f in convs) == 14
    projections = [name for name, m in model.named_modules() if name.endswith("conv1")
                   and isinstance(m, conv3d.Conv3d)]
    assert projections == [f"encoders.{i}.basic_module.conv1" for i in range(5)]
    deconvs = [m for m in model.modules() if isinstance(m, torch.nn.ConvTranspose3d)]
    assert [(m.in_channels, m.out_channels) for m in deconvs] == [(512, 256), (256, 128), (128, 64), (64, 32)]
    assert all(m.kernel_size == (3, 3, 3) and m.stride == (2, 2, 2) and m.bias is None for m in deconvs)


def test_deconv_gives_2n_minus_1_then_the_skip_size():
    up = blocks.TransposeConvUpsampling(4, 2)
    x = torch.rand(1, 4, 3, 5, 6)
    assert up.upsample.conv_transposed(x).shape[2:] == (5, 9, 11)
    assert up(x, (7, 10, 12)).shape == (1, 2, 7, 10, 12)


@pytest.mark.parametrize("order,act", [("gcr", torch.nn.ReLU), ("gce", torch.nn.ELU), ("gcl", torch.nn.LeakyReLU)])
def test_resnet_block_strips_the_activation_of_conv3(order, act):
    block = blocks.ResNetBlock(4, 8, order=order, num_groups=2)
    assert isinstance(block.conv1, conv3d.Conv3d) and block.conv1.kernel_size == (1, 1, 1)
    assert [type(m) for m in block.conv3.children()] == [blocks.GroupNorm, conv3d.Conv3d]
    assert isinstance(block.non_linearity, act)
    if act is torch.nn.LeakyReLU:
        assert block.non_linearity.negative_slope == 0.1
    assert isinstance(blocks.ResNetBlock(8, 8, order=order, num_groups=2).conv1, torch.nn.Identity)


def test_se_layers_follow_their_formulas():
    torch.manual_seed(4)
    x = torch.randn(2, 6, 3, 4, 5)
    cse, sse, scse = se.ChannelSELayer3D(6, 2), se.SpatialSELayer3D(6), se.ChannelSpatialSELayer3D(6, 1)
    gate = torch.sigmoid(cse.fc2(torch.relu(cse.fc1(x.mean((2, 3, 4))))))
    torch.testing.assert_close(cse(x), x * gate[:, :, None, None, None])
    assert cse.fc1.out_features == 3
    spatial = torch.sigmoid(torch.einsum("ncdhw,c->ndhw", x, sse.conv.weight.flatten()) + sse.conv.bias)
    torch.testing.assert_close(sse(x), x * spatial[:, None])
    torch.testing.assert_close(scse(x), torch.maximum(scse.cSE(x), scse.sSE(x)))
    block = blocks.ResNetBlockSE(4, 6, order="gcr", num_groups=2)
    assert isinstance(block.se_module, se.ChannelSpatialSELayer3D) and block.se_module.cSE.fc1.out_features == 6


def _target(shape, seed):
    """(boundary, label) target of boxes of random ids, as the lightsheet
    recipe's StandardLabelToBoundary(append_label=True) feeds BCEDiceLoss with
    skip_last_target."""
    rs = np.random.RandomState(seed)
    label = np.kron(rs.randint(1, 9, (shape[0] // 2, shape[1] // 4, shape[2] // 4)), np.ones((2, 4, 4)))
    boundary = np.zeros(shape)
    boundary[:, :, 1:] += label[:, :, 1:] != label[:, :, :-1]
    boundary[:, 1:, :] += label[:, 1:, :] != label[:, :-1, :]
    boundary[1:] += label[1:] != label[:-1]
    return np.stack([boundary > 0, label]).astype(np.float32)[None]


@pytest.mark.parametrize("name", FAMILIES)
def test_step_grads_match_jax_grad(variables, name):
    """Every parameter gradient of one BCEDiceLoss step within 1e-4 * max|g|
    of `jax.grad`, max|g| of each tensor on its own: the deep and SE tensors'
    gradients are down to 1.3e-4 of the step's largest, so a bound taken over
    the whole step would pass any error there. Measured on the CPU, the worst
    tensor is 7.8e-6 of its own max|g|; the 1e-6 * max over the step only
    keeps a zero gradient from asking for an exact zero."""
    x = _input(SHAPES["exact"], seed=7)
    target = _target(SHAPES["exact"], 7)
    jax_model = jax_get_model(_cfg(name))
    criterion = jax_get_loss_criterion({"loss": dict(LOSS)})

    @jax.jit
    def grad_fn(params):
        return jax.grad(lambda p: criterion(jax_model.module.apply({"params": p}, x, train=True)[1],
                                            jnp.asarray(np.moveaxis(target, 1, -1))))(params)

    want = state_dict_from_jax({"params": grad_fn(variables[name]["params"])})
    model = _port_model(name, variables[name]).train()
    get_loss_criterion({"loss": dict(LOSS)})(model(torch.from_numpy(np.moveaxis(x, -1, 1)))[1],
                                             torch.from_numpy(target)).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    g_max = max(np.abs(g.numpy()).max() for g in want.values())
    for key, expected in want.items():
        scale = max(np.abs(expected.numpy()).max(), 1e-6 * g_max)
        np.testing.assert_allclose(got[key].grad.numpy(), expected.numpy(), rtol=0, atol=1e-4 * scale, err_msg=key)


@pytest.mark.parametrize("name", FAMILIES)
def test_state_dict_round_trips(variables, name, tmp_path):
    src = _port_model(name, variables[name])
    assert set(state_dict_from_jax(variables[name])) == set(src.state_dict())
    path = tmp_path / "weights.pytorch"
    torch.save({"model_state_dict": src.state_dict()}, path)
    dst = get_model(_cfg(name))
    load_weights(dst, path)
    for key, value in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[key], value, rtol=0, atol=0, msg=key)


def test_se_keys_are_the_reference_names():
    keys = set(ResidualUNetSE3D(in_channels=1, out_channels=1, f_maps=8, num_groups=4, num_levels=2).state_dict())
    for key in ("encoders.0.basic_module.se_module.cSE.fc1.weight", "encoders.0.basic_module.se_module.cSE.fc2.bias",
                "encoders.0.basic_module.se_module.sSE.conv.weight",
                "decoders.0.upsampling.upsample.conv_transposed.weight", "decoders.0.basic_module.conv2.conv.weight"):
        assert key in keys, key


def test_explicit_deconv_joins_by_concat_as_jax():
    # JAX unet.py `_resolve_upsample`: a named mode keeps concat joins
    model = get_model({**_cfg("ResidualUNet3D"), "upsample": "deconv"})
    decoder = model.decoders[0]
    assert decoder.concat and decoder.upsampling is not None
    assert decoder.basic_module.conv1.in_channels == 2 * decoder.basic_module.conv1.out_channels


MODEL = {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 8,
         "num_groups": 4, "num_levels": 3, "final_sigmoid": True}


def _predict_config(tmp, output_dir):
    return {
        "device": "cpu", "model_path": os.path.join(tmp, "weights.pytorch"), "model": dict(MODEL),
        "predictor": {"name": "StandardPredictor"},
        "loaders": {"dataset": "StandardHDF5Dataset", "output_dir": output_dir, "batch_size": 1, "num_workers": 1,
                    "raw_internal_path": "raw", "global_normalization": True,
                    "test": {"file_paths": [os.path.join(tmp, "test.h5")],
                             "slice_builder": {"name": "SliceBuilder", "patch_shape": [8, 64, 64],
                                               "stride_shape": [8, 64, 64], "halo_shape": [2, 4, 4]},
                             "transformer": {"raw": [{"name": "Standardize"},
                                                     {"name": "ToTensor", "expand_dims": True}]}}},
    }


def test_predict_cli_matches_jax_predict3dunet(tmp_path):
    """A ResidualUNet3D checkpoint written by the JAX package, the JAX
    predict3dunet and the port's predict CLI (a fresh interpreter that imports
    nothing of jax or the JAX package) on the same 16x64x64 volume."""
    tmp = str(tmp_path)
    with h5py.File(os.path.join(tmp, "test.h5"), "w") as f:
        f.create_dataset("raw", data=np.random.RandomState(0).rand(16, 64, 64).astype(np.float32))
    torch.manual_seed(3)
    state = {k: v.numpy() for k, v in get_model(MODEL).state_dict().items()}
    save_torch_checkpoint({"params": torch_state_dict_to_params(state)}, os.path.join(tmp, "weights.pytorch"))

    paths = {}
    for side in ("jax", "port"):
        paths[side] = os.path.join(tmp, f"{side}.yml")
        with open(paths[side], "w") as f:
            yaml.safe_dump(_predict_config(tmp, os.path.join(tmp, f"{side}_out")), f)
    from pytorch3dunet_tpu import predict as jax_predict

    argv = sys.argv
    sys.argv = ["predict3dunet", "--config", paths["jax"]]
    try:
        jax_predict.main()
    finally:
        sys.argv = argv
    script = ("import runpy, sys\n"
              f"sys.argv = ['predict', '--config', {paths['port']!r}]\n"
              "runpy.run_module('pytorch3dunet_tpu_torch.predict', run_name='__main__')\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pytorch3dunet_tpu'))\n"
              "assert not bad, f'the port imported {bad}'\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outputs = {}
    for side in ("jax", "port"):
        with h5py.File(os.path.join(tmp, f"{side}_out", "test_predictions.h5"), "r") as f:
            outputs[side] = f["predictions"][:]
    assert outputs["port"].shape == (1, 16, 64, 64)
    np.testing.assert_allclose(outputs["port"], outputs["jax"], atol=FORWARD_TOL)
