"""bf16 training in the port against the JAX package, and the three `_tpu`
train configs that need nothing else (device augmentation and a bf16 model)
through the port's train CLI.

A bf16 step keeps float32 parameters, gradients and Adam moments; the model
computes in bf16 as the bf16 forward does (tests/test_torch_port_bf16.py).
Its gradients are bf16-noisy: at this width the JAX bf16 step's own gradients
sit 0.122 (relative L2 over all tensors) from the JAX f32 step's, and up to
0.6 on single GroupNorm tensors whose f32 gradient is near zero. So two
global bounds hold the port, as the bf16 forward was held:
- with its plain conv rounded as the JAX conv (`jax_conv_rounding`), its bf16
  step against `jax.grad` of the JAX bf16 model: within BF16_GRAD_L2_TOL
  (relative L2) and BF16_GRAD_MAX_TOL (max |d| / max |g|);
- as it is, against the f32 step: within twice the JAX bf16 step's own
  distance from the JAX f32 step, in both measures.
The trajectory is SGD's (Adam's eps rounds differently, ROADMAP F4).
"""

import copy
import functools
import os

import h5py
import jax
import numpy as np
import optax
import pytest
import torch
import yaml
from test_torch_port_bf16 import jax_conv_rounding  # noqa: F401 (a fixture)
from test_torch_port_model import _jax_model_and_variables
from test_torch_port_train import LOSS, MODEL, _batches, _channels_last, _jax_step_fn

from pytorch3dunet_tpu import predict as jax_predict
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu_torch import train, trainer as port_trainer
from pytorch3dunet_tpu_torch.losses import get_loss_criterion
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint
from pytorch3dunet_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_MODEL = {**MODEL, "num_levels": 3, "dtype": "bfloat16"}
SHAPE = (16, 32, 32)
# measured on the CPU, this seed and batch: the emulated port step against the
# JAX bf16 step 0.0825 (relative L2) and 0.0547 (max |d| / max |g|)
BF16_GRAD_L2_TOL, BF16_GRAD_MAX_TOL = 0.1, 0.07
# the SGD losses of 3 steps, port (emulated rounding) against the JAX bf16
# step: measured 2.11e-4
BF16_LOSS_TOL = 1e-3
SGD_LR = 0.05


def _l2(got, want):
    """Relative L2 distance over all tensors."""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float((want[k] ** 2).sum()) for k in want)) ** 0.5


def _max(got, want):
    """max |d| over all tensors / max |g| of `want`."""
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / max(float(np.abs(v).max())
                                                                         for v in want.values())


@functools.cache
def _jax_run():
    """The JAX SGD trajectory of 3 steps in bf16 (its first step's gradients)
    and the f32 gradients of the same first step, from the same weights."""
    jax_model, variables = _jax_model_and_variables({**MODEL, "num_levels": 3}, seed=3)
    batches = _batches(3, seed=3, shape=SHAPE)
    out = {"variables": variables, "batches": batches}
    for dtype in (None, "bfloat16"):
        tx = optax.sgd(SGD_LR)
        step = _jax_step_fn(jax_get_model({**BF16_MODEL, "dtype": dtype}), tx)
        params, opt_state, losses = variables["params"], tx.init(variables["params"]), []
        for i, batch in enumerate(batches if dtype else batches[:1]):
            params, opt_state, loss, grads = step(params, opt_state, *_channels_last(batch))
            losses.append(float(loss))
            if i == 0:
                out["grads", dtype] = {k: v.numpy() for k, v in state_dict_from_jax({"params": grads}).items()}
        out["losses", dtype] = losses
    return out


def _port_grads(dtype):
    run = _jax_run()
    model = get_model({**BF16_MODEL, "dtype": dtype}).train()
    model.load_state_dict(state_dict_from_jax(run["variables"]), strict=True)
    raw, target = run["batches"][0]
    loss = get_loss_criterion({"loss": dict(LOSS)})(model(torch.from_numpy(raw))[1], torch.from_numpy(target))
    assert loss.dtype == torch.float32
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    return {k: g.numpy() for k, g in grads.items()}


def test_bf16_step_grads_match_jax_grad(jax_conv_rounding):
    want = _jax_run()["grads", "bfloat16"]
    got = _port_grads("bfloat16")
    assert set(got) == set(want)
    assert _l2(got, want) <= BF16_GRAD_L2_TOL
    assert _max(got, want) <= BF16_GRAD_MAX_TOL


# measured: port bf16 against port f32 0.107 (L2) and 0.0648 (max); the JAX
# bf16 step against the JAX f32 step 0.122 and 0.0805
def test_bf16_step_grads_are_within_twice_the_jax_bf16_error():
    run = _jax_run()
    jax_f32, jax_bf16 = run["grads", None], run["grads", "bfloat16"]
    got, port_f32 = _port_grads("bfloat16"), _port_grads(None)
    for measure in (_l2, _max):
        assert measure(got, port_f32) <= 2 * measure(jax_bf16, jax_f32)
        assert measure(got, jax_f32) <= 2 * measure(jax_bf16, jax_f32)


def _trainer_config(tmp, optimizer):
    return {"device": "cpu", "manual_seed": 0, "model": dict(BF16_MODEL), "loss": dict(LOSS),
            "eval_metric": {"name": "BoundaryAdaptedRandError", "threshold": 0.4, "use_last_target": True,
                            "use_first_input": True},
            "optimizer": optimizer,
            "trainer": {"checkpoint_dir": str(tmp), "eval_score_higher_is_better": False,
                        "validate_after_iters": 10**6, "log_after_iters": 10**6, "max_num_epochs": 1,
                        "max_num_iterations": 100}}


def test_bf16_sgd_trajectory_matches_jax(tmp_path, jax_conv_rounding):
    run = _jax_run()
    trainer = create_trainer(_trainer_config(tmp_path, {"name": "SGD", "learning_rate": SGD_LR}),
                             loaders={"train": run["batches"], "val": []})
    trainer.model.load_state_dict(state_dict_from_jax(run["variables"]), strict=True)
    losses = []
    criterion = trainer.loss_criterion
    trainer.loss_criterion = lambda logits, target: losses.append(criterion(logits, target)) or losses[-1]
    trainer.fit()
    port = [loss.item() for loss in losses]
    np.testing.assert_allclose(port, run["losses", "bfloat16"], rtol=0, atol=BF16_LOSS_TOL)
    assert port[-1] < port[0]


def test_bf16_adam_keeps_float32_parameters_and_moments(tmp_path):
    batches = _batches(2, seed=4)
    config = _trainer_config(tmp_path, {"learning_rate": 1e-3, "weight_decay": 1e-5})
    config["model"]["num_levels"] = 2
    trainer = create_trainer(config, loaders={"train": batches, "val": []})
    trainer.fit()
    assert trainer.model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    state = trainer.optimizer.state_dict()["state"]
    assert len(state) == len(list(trainer.model.parameters()))
    for moments in state.values():
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32
        assert int(moments["step"]) == 2


# --- the `_tpu` train configs through the port's CLI ------------------------------------------------------------

TPU_TRAIN_CONFIGS = {
    "confocal_boundary": "3DUnet_confocal_boundary_tpu/train_config.yml",
    "lightsheet_boundary": "3DUnet_lightsheet_boundary_tpu/train_config.yml",
    "lightsheet_nuclei": "3DUnet_lightsheet_nuclei_tpu/train_config.yaml",
    "multiclass": "3DUnet_multiclass_tpu/train_config.yaml",
    "denoising": "3DUnet_denoising_tpu/train_config_regression.yaml",
}
PATCH = (8, 64, 64)  # the slice builders take H, W >= 64; square for rot90


def _load(name):
    with open(os.path.join(REPO, "resources", TPU_TRAIN_CONFIGS[name])) as f:
        return yaml.safe_load(f)


def _write_volume(path, seed, label_path="label"):
    """An 8 x 64 x 64 raw and its instance label of boxes (ids 1..19)."""
    rs = np.random.RandomState(seed)
    cells = rs.randint(1, 20, (2, 8, 8))
    label = np.kron(cells, np.ones((4, 8, 8), dtype=cells.dtype))
    raw = (label % 3).astype(np.float32) + 0.5 * rs.rand(*PATCH).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.create_dataset("raw", data=raw)
        f.create_dataset(label_path, data=label.astype(np.int64) if label_path == "label" else raw)


def _shrunk(config, tmp):
    """The config on the CPU at f_maps 8, num_groups 4, 2 levels, on one
    8 x 64 x 64 patch of this test's files (random_scale 2, below the
    stride), 3 iterations with a validation and a log at iteration 2."""
    config = copy.deepcopy(config)
    config["device"] = "cpu"
    config["manual_seed"] = 0
    config["model"].update(f_maps=8, num_groups=4, num_levels=2)
    config["trainer"].update(checkpoint_dir=os.path.join(tmp, "checkpoints"), validate_after_iters=2,
                             log_after_iters=2, max_num_iterations=2, max_num_epochs=10)
    loaders = config["loaders"]
    loaders["num_workers"] = 1
    if "random_scale" in loaders:
        loaders["random_scale"] = 2
    for phase in ("train", "val"):
        loaders[phase]["file_paths"] = [os.path.join(tmp, f"{phase}.h5")]
        loaders[phase]["slice_builder"].update(patch_shape=list(PATCH), stride_shape=list(PATCH))
    return config


@pytest.mark.parametrize("name", ["confocal_boundary", "lightsheet_boundary", "lightsheet_nuclei"])
def test_tpu_train_config_trains_through_the_cli(name, tmp_path, monkeypatch):
    config = _shrunk(_load(name), str(tmp_path))
    assert config["loaders"]["device_augment"] and config["model"]["dtype"] == "bfloat16"
    for phase, seed in (("train", 0), ("val", 1)):
        _write_volume(tmp_path / f"{phase}.h5", seed)
    path = tmp_path / "train_config.yml"
    path.write_text(yaml.safe_dump(config))
    stats, augmented = [], []
    log_stats = port_trainer.UNetTrainer._log_stats
    monkeypatch.setattr(port_trainer.UNetTrainer, "_log_stats",
                        lambda self, phase, loss, score: stats.append((phase, loss, score)) or log_stats(self, phase,
                                                                                                        loss, score))
    augment = port_trainer.DeviceAugmenter.__call__
    monkeypatch.setattr(port_trainer.DeviceAugmenter, "__call__",
                        lambda self, *args: augmented.append(augment(self, *args)) or augmented[-1])
    train.main(["--config", str(path)])

    # 3 train batches augmented; targets engineered on the device: 2 channels
    assert len(augmented) == 3 and all(t.shape == (1, 2, *PATCH) for _, t in augmented)
    assert {phase for phase, _, _ in stats} == {"train", "val"}
    assert all(np.isfinite(loss) and np.isfinite(score) for _, loss, score in stats), stats
    checkpoint = os.path.join(config["trainer"]["checkpoint_dir"], "last_checkpoint.pytorch")
    state = load_checkpoint(checkpoint)
    assert {v.dtype for v in state["model_state_dict"].values() if v.is_floating_point()} == {torch.float32}
    get_model({**config["model"], "dtype": None}).load_state_dict(state["model_state_dict"], strict=True)
    # the weights predict3dunet loads
    variables = jax_predict.load_model_variables(jax_get_model(dict(config["model"])), checkpoint)
    want = state_dict_from_jax(jax.device_get(variables))
    assert set(want) <= set(state["model_state_dict"])
    for key, value in want.items():
        np.testing.assert_array_equal(value.numpy(), state["model_state_dict"][key].numpy(), err_msg=key)


@pytest.mark.parametrize("name", ["multiclass", "denoising"])
def test_tpu_train_configs_with_unported_losses_refuse(name, tmp_path):
    config = _shrunk(_load(name), str(tmp_path))
    with pytest.raises(NotImplementedError, match="The rest of the losses and metrics"):
        create_trainer(config, loaders={"train": [], "val": []})
