"""The 2D families (UNet2D, ResidualUNet2D) of the port against the JAX
package on the CPU: forwards with GroupNorm and BatchNorm (eval and train
mode), one step's gradients, a bf16 forward, the trainer's 2D batches and
host metrics, and the device sweep (grid and full-plane slab). The CLIs are in
tests/test_torch_port_2d_cli.py.

The weights start in JAX with the norm affines and statistics randomized and
cross with the port's export (`state_dict_from_jax`). BatchNorm's running
variance: flax updates it with the biased batch variance, torch with the
unbiased one (ROADMAP F2), so the JAX update is scaled by n / (n - 1).
"""

import jax
import numpy as np
import pytest
import torch

from pytorch3dunet_tpu import predictor as jax_predictor
from pytorch3dunet_tpu.augment.transforms import StandardLabelToBoundary
from pytorch3dunet_tpu.losses import get_loss_criterion as jax_get_loss_criterion
from pytorch3dunet_tpu.metrics import get_evaluation_metric as jax_get_evaluation_metric
from pytorch3dunet_tpu.metrics import to_metric_layout
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model, is_model_2d
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_bf16 import BF16_TOL
from tests.test_torch_port_model import _randomize
from tests.test_torch_port_train import LOSS

TOL = 2e-4
MODEL = {"in_channels": 1, "out_channels": 1, "f_maps": 8, "num_groups": 4, "num_levels": 3, "final_sigmoid": True}


def _jax(cfg, seed=0):
    """The JAX model and its variables (init jitted, norms randomized)."""
    jax_model = jax_get_model(dict(cfg))
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed)
    return jax_model, {k: _randomize(v, rs) for k, v in variables.items()}


def _port(cfg, variables):
    model = get_model(dict(cfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _batch(seed, n=2, hw=(32, 32)):
    """(raw (N, 1, H, W), target (N, 2, H, W)): boxes of random ids through
    StandardLabelToBoundary(append_label=True), as the 2D confocal recipe
    feeds BCEDiceLoss with skip_last_target."""
    rs = np.random.RandomState(seed)
    raws, targets = [], []
    for _ in range(n):
        label = np.kron(rs.randint(1, 20, (1, hw[0] // 8, hw[1] // 8)), np.ones((1, 8, 8), dtype=np.int64))
        target = StandardLabelToBoundary(append_label=True)(label).astype(np.float32)[:, 0]
        raws.append((target[:1] + 0.5 * rs.randn(1, *hw)).astype(np.float32))
        targets.append(target)
    return np.stack(raws), np.stack(targets)


# --- forwards -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name,order,hw", [
    ("UNet2D", "gcr", (32, 32)), ("UNet2D", "bcr", (30, 34)),
    ("ResidualUNet2D", "gcr", (30, 34)), ("ResidualUNet2D", "bcr", (32, 32)),
])
def test_forward_matches_jax(name, order, hw):
    cfg = {**MODEL, "name": name, "layer_order": order, "out_channels": 2, "final_sigmoid": False}
    jax_model, variables = _jax(cfg)
    model = _port(cfg, variables).eval()
    assert is_model_2d(model) and not is_model_2d(get_model({**cfg, "name": "UNet3D"}))
    x = np.random.RandomState(5).rand(2, *hw, 1).astype(np.float32)
    want_probs, want_logits = jax.jit(lambda v, xi: jax_model.apply(v, xi))(variables, x)
    with torch.inference_mode():
        probs, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.numpy(), np.moveaxis(np.asarray(want_logits), -1, 1), rtol=0, atol=TOL)
    np.testing.assert_allclose(probs.numpy(), np.moveaxis(np.asarray(want_probs), -1, 1), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["UNet2D", "ResidualUNet2D"])
def test_batchnorm_train_mode_matches_jax(name):
    """Train-mode BatchNorm normalizes with the batch statistics and updates
    the running ones: the running mean as flax, the running variance's update
    n / (n - 1) times flax's (n the values per channel)."""
    cfg = {**MODEL, "name": name, "layer_order": "bcr"}
    jax_model, variables = _jax(cfg)
    model = _port(cfg, variables).train()
    x = np.random.RandomState(6).rand(2, 32, 32, 1).astype(np.float32)
    (_, want_logits), updated = jax.jit(lambda v, xi: jax_model.apply(v, xi, train=True, mutable=["batch_stats"]))(
        variables, x)
    bns = {n: m for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    assert len(bns) == 10
    # the values each BatchNorm reduces per channel: N x H x W of its input (a
    # fused decoder's first norm: of the concat it never materializes), the
    # plane of its level (32 >> level; decoder i joins level 1 - i)
    level = {"encoders": lambda i: i, "decoders": lambda i: 1 - i}
    counts = {key: x.shape[0] * (32 >> level[key.split(".")[0]](int(key.split(".")[1]))) ** 2 for key in bns}
    _, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(logits.detach().numpy(), np.moveaxis(np.asarray(want_logits), -1, 1), rtol=0,
                               atol=TOL)
    before = state_dict_from_jax(variables)
    after = state_dict_from_jax({**variables, "batch_stats": updated["batch_stats"]})
    for key, bn in bns.items():
        np.testing.assert_allclose(bn.running_mean.numpy(), after[f"{key}.running_mean"].numpy(), rtol=0, atol=1e-5)
        old, n = 0.9 * before[f"{key}.running_var"].numpy(), counts[key]
        np.testing.assert_allclose(bn.running_var.numpy() - old,
                                   (after[f"{key}.running_var"].numpy() - old) * n / (n - 1), rtol=1e-4, atol=1e-6)
        assert bn.num_batches_tracked.item() == 1


# --- one step's gradients, bf16 -------------------------------------------------------------------------------


@pytest.mark.parametrize("name,order", [("UNet2D", "gcr"), ("ResidualUNet2D", "gcr"), ("UNet2D", "bcr")])
def test_step_grads_match_jax_grad(name, order):
    """Every parameter gradient of one BCEDiceLoss step within 1e-4 * max|g|
    of `jax.grad` (num_groups 4, no dropout: ROADMAP F5)."""
    cfg = {**MODEL, "name": name, "layer_order": order}
    jax_model, variables = _jax(cfg, seed=3)
    raw, target = _batch(3)
    criterion = jax_get_loss_criterion({"loss": dict(LOSS)})

    def loss_fn(params):
        # train-mode BatchNorm: batch statistics, the running ones updated aside
        (_, logits), _ = jax_model.module.apply({**variables, "params": params}, np.moveaxis(raw, 1, -1), train=True,
                                                mutable=["batch_stats"])
        return criterion(logits, np.moveaxis(target, 1, -1))

    want = state_dict_from_jax({"params": jax.jit(jax.grad(loss_fn))(variables["params"])})
    model = _port(cfg, variables).train()
    get_loss_criterion({"loss": dict(LOSS)})(model(torch.from_numpy(raw))[1], torch.from_numpy(target)).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    g_max = max(np.abs(g.numpy()).max() for g in want.values())
    for key, expected in want.items():
        np.testing.assert_allclose(got[key].grad.numpy(), expected.numpy(), rtol=0, atol=1e-4 * g_max, err_msg=key)


def test_bf16_forward_matches_jax():
    """The bf16 forward of UNet2D against the JAX bf16 one within the 3D bf16
    tests' tolerance; the 2D conv rounds alike in both (one conv, then the
    bias) up to where the bias is added, so no emulation is needed."""
    cfg = {**MODEL, "name": "UNet2D", "layer_order": "gcr", "out_channels": 2, "final_sigmoid": False}
    jax_model, variables = _jax(cfg)
    x = np.random.RandomState(0).randn(2, 64, 64, 1).astype(np.float32)
    want = jax.jit(lambda v, xi: jax_get_model({**cfg, "dtype": "bfloat16"}).apply(v, xi))(variables, x)[0]
    model = _port({**cfg, "dtype": "bfloat16"}, variables).eval()
    with torch.inference_mode():
        probs, logits = model(torch.from_numpy(np.moveaxis(x, -1, 1)))
    assert probs.dtype == logits.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.moveaxis(np.asarray(want), -1, 1), rtol=0, atol=BF16_TOL)


# --- the trainer's 2D batches and host metrics ----------------------------------------------------------------


@pytest.mark.parametrize("metric", [
    {"name": "BoundaryAdaptedRandError", "threshold": 0.4, "use_last_target": True, "use_first_input": True},
    {"name": "BlobsAveragePrecision", "use_last_target": True, "metric": "ap"},
])
def test_validation_scores_2d_batches_as_jax(tmp_path, metric):
    """The trainer strips the loader batch's singleton z for the forward and
    hands the host metric (N, C, 1, H, W) again: the score of the JAX
    metric on the JAX model's probabilities in `to_metric_layout(..., is3d=False)`."""
    cfg = {**MODEL, "name": "UNet2D", "layer_order": "gcr"}
    jax_model, variables = _jax(cfg, seed=2)
    raw, target = _batch(2)
    loader = [(raw[:, :, None], target[:, :, None])]
    config = {"device": "cpu", "manual_seed": 0, "model": dict(cfg), "loss": dict(LOSS), "eval_metric": metric,
              "optimizer": {"learning_rate": 1e-3},
              "trainer": {"checkpoint_dir": str(tmp_path), "validate_after_iters": 1, "log_after_iters": 1,
                          "max_num_epochs": 1, "max_num_iterations": 1}}
    trainer = create_trainer(config, loaders={"train": loader, "val": loader})
    trainer.model.load_state_dict(state_dict_from_jax(variables), strict=True)
    inp, tgt = trainer._prepare_batch(*loader[0])
    assert inp.shape == (2, 1, 32, 32) and tgt.shape == (2, 2, 32, 32)
    got = trainer.validate()
    probs = jax.jit(lambda v, xi: jax_model.apply(v, xi))(variables, np.moveaxis(raw, 1, -1))[0]
    out, tar = to_metric_layout(np.asarray(probs), np.moveaxis(target, 1, -1), is3d=False)
    assert out.shape == (2, 1, 1, 32, 32) and tar.shape == (2, 2, 1, 32, 32)
    want = float(jax_get_evaluation_metric({"eval_metric": metric})(out, tar))
    assert got == pytest.approx(want, abs=1e-6)
    trainer.fit()  # a train step scores the 2D batch on the host too (log_after_iters 1)
    with pytest.raises(ValueError, match="depth 1"):
        trainer._prepare_batch(np.zeros((1, 1, 2, 32, 32), np.float32), np.zeros((1, 2, 2, 32, 32), np.float32))


# --- the device sweep -----------------------------------------------------------------------------------------

SWEEP_MODEL = {**MODEL, "name": "UNet2D", "layer_order": "gcr", "out_channels": 2, "final_sigmoid": False,
               "num_levels": 2}
HALO = (0, 4, 4)


@pytest.fixture(scope="module")
def sweep_models():
    jax_model, variables = _jax(SWEEP_MODEL, seed=1)
    return jax_model, variables, _port(SWEEP_MODEL, variables).eval()


@pytest.mark.parametrize("stride,options", [
    ((1, 32, 32), {}),                                          # patch_batch 16 by default
    ((1, 16, 16), {"blend": "gaussian", "patch_batch": 3}),     # overlapping tiles
    ((1, 32, 32), {"tta": True}),                               # mirrors y and x only
    ((1, 32, 32), {"patch_mode": "slab"}),                      # whole planes, 24 (here 5) a forward
    ((1, 32, 32), {"patch_mode": "slab", "max_patch_voxels": 3 * 48 * 44, "patch_batch": 3}),
])
def test_device_sweep_matches_jax(sweep_models, stride, options):
    jax_model, variables, model = sweep_models
    volume = (np.random.RandomState(2).rand(5, 40, 36) * 3 + 1).astype(np.float32)
    stats = {"mean": float(volume.mean()), "std": float(volume.std())}
    want = jax_predictor.DeviceSlidingWindowPredictor(jax_model, variables, None, 2, shard=False, **options)
    got = DeviceSlidingWindowPredictor(model, None, 2, "cpu", **options)
    args = (volume, (1, 32, 32), stride, HALO)
    want_out = want.predict_array(*args, normalize="standardize", stats=stats)
    got_out = got.predict_array(*args, normalize="standardize", stats=stats)
    assert got_out.shape == want_out.shape == (2, 5, 40, 36)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=TOL)
    if options.get("patch_mode") == "slab":
        assert got._planned_patch_batch == want._planned_patch_batch == min(options.get("patch_batch", 24), 5)
    sweep = next(iter(got._sweeps.values()))
    assert sweep.patch_batch == (options.get("patch_batch") or (5 if "patch_mode" in options else 16))
