"""The port trainer's breadth (pytorch3dunet_tpu_torch/trainer.py) against the
JAX package: TensorBoard, EMA, gradient accumulation, `resume: auto` with the
random streams restored, async checkpoints, `model.remat`, profiler traces and
parameter histograms, and `pre_trained` from a JAX npz.

One JAX `train3dunet` trainer and the port's run the same config from the same
weights (SGD, `ema_decay`, `grad_accum_steps: 2` over the two patches of the
train volume, so the shuffle cannot change a group): TensorBoard tags, steps
and scalars, the EMA and the raw weights are held to it. Everything else is
held to the port's own reference computation (a float64 recurrence, a batch-2
step, an uninterrupted run), with each tolerance stated at its assert.
"""

import copy
import glob
import inspect
import logging
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from pytorch3dunet_tpu import trainer as jax_trainer
from pytorch3dunet_tpu.models import get_model as jax_get_model
from pytorch3dunet_tpu.predict import load_model_variables as jax_load_model_variables
from pytorch3dunet_tpu.utils import tb as jax_tb
from pytorch3dunet_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from pytorch3dunet_tpu.utils.torch_interop import save_torch_checkpoint
from pytorch3dunet_tpu_torch import trainer as port_trainer
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predict import run as predict_run
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils import tb as port_tb
from pytorch3dunet_tpu_torch.utils.checkpoint import load_checkpoint
from pytorch3dunet_tpu_torch.utils.misc import RunningAverage
from pytorch3dunet_tpu_torch.utils.weights import load_weights, state_dict_from_jax
from tests.test_torch_port_model import _jax_model_and_variables
from tests.test_torch_port_train import CLI_PATCH, MODEL, _batches, _cli_config, _config, _label, _write_volume

SGD = {"name": "SGD", "learning_rate": 0.05, "momentum": 0.9}


def test_port_trainer_takes_every_key_of_the_jax_trainer():
    # the JAX constructor's keys, less what create_trainer builds (the model,
    # the optimizer and scheduler configs, the seed from manual_seed)
    jax_keys = set(inspect.signature(jax_trainer.UNetTrainer.__init__).parameters)
    port_keys = set(inspect.signature(port_trainer.UNetTrainer.__init__).parameters)
    assert jax_keys - {"optimizer_config", "lr_scheduler_config", "seed"} <= port_keys


# --- TensorboardFormatter: the cases of tests/test_tb.py ------------------------------------------------------------

FORMATTER_CASES = [
    ({}, "predictions", (2, 1, 8, 6, 5), float),
    ({}, "predictions", (1, 4, 6, 5, 5), float),
    ({"log_channelwise": True}, "predictions", (1, 3, 6, 5, 5), float),
    ({"skip_last_target": True}, "targets", (1, 2, 6, 5, 5), float),
    ({}, "inputs", (1, 5, 6, 4, 4), float),
    ({}, "inputs", (1, 3, 6, 4, 4), float),
    ({}, "targets", (2, 8, 5, 5), int),
    ({}, "predictions", "constant", float),
]


@pytest.mark.parametrize("kwargs,name,shape,kind", FORMATTER_CASES)
def test_tensorboard_formatter_matches_jax(kwargs, name, shape, kind):
    # the same tags and images, exactly (the same numpy arithmetic)
    rs = np.random.RandomState(3)
    if shape == "constant":
        batch = np.full((1, 1, 4, 3, 3), 7.0, dtype=np.float32)
    elif kind is int:
        batch = rs.randint(0, 4, size=shape)
    else:
        batch = rs.rand(*shape).astype(np.float32)
    got = port_tb.TensorboardFormatter(**kwargs)(name, batch)
    want = jax_tb.TensorboardFormatter(**kwargs)(name, batch)
    assert [tag for tag, _ in got] == [tag for tag, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_no_tensorboardx_keeps_the_scalars_in_the_log(monkeypatch, caplog, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name.startswith("tensorboardX"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    with caplog.at_level(logging.WARNING, logger="TensorBoard"):
        assert port_tb.open_writer(str(tmp_path)) is None
    assert "tensorboardX is not installed" in caplog.text


# --- one JAX trainer and the port's on the same config ---------------------------------------------------------------


def _events(checkpoint_dir):
    """{kind: {tag: [(step, value)]}} of the one TensorBoard run under checkpoint_dir/logs."""
    # TensorBoard's own "no TensorFlow" switch: its reader without importing
    # TensorFlow, which takes seconds
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
    (run,) = [d for d in glob.glob(os.path.join(checkpoint_dir, "logs", "*")) if glob.glob(os.path.join(d, "ev*"))]
    acc = EventAccumulator(run, size_guidance={"scalars": 0, "images": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    return {"scalars": {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]},
            "images": {t: [(e.step, (e.height, e.width)) for e in acc.Images(t)] for t in tags["images"]},
            "histograms": {t: [e.step for e in acc.Histograms(t)] for t in tags["histograms"]}}


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """The JAX trainer and the port's on one config: 3 updates of 2
    accumulated batch-1 patches, SGD with momentum, EMA 0.9, StepLR, a
    validation and a checkpoint at iteration 2, a log at every iteration."""
    tmp = str(tmp_path_factory.mktemp("paired"))
    _write_volume(os.path.join(tmp, "train.h5"), 0, shape=(CLI_PATCH[0], CLI_PATCH[1], 2 * CLI_PATCH[2]))
    _write_volume(os.path.join(tmp, "val.h5"), 1)
    _, variables = _jax_model_and_variables(MODEL, seed=2)
    start = os.path.join(tmp, "start.pytorch")
    save_torch_checkpoint(variables, start)
    runs = {}
    for side, create in (("jax", jax_trainer.create_trainer), ("port", create_trainer)):
        config = _cli_config(tmp, pre_trained=start, ema_decay=0.9, grad_accum_steps=2, log_after_iters=1,
                             checkpoint_dir=os.path.join(tmp, side))
        config["optimizer"] = dict(SGD)
        config["lr_scheduler"] = {"name": "StepLR", "step_size": 1, "gamma": 0.5}
        np.random.seed(0)
        trainer = create(config)
        trainer.fit()
        # the JAX trainer leaves its writer open: close it to drain its queue
        trainer.writer.close()
        runs[side] = {"dir": config["trainer"]["checkpoint_dir"], "trainer": trainer, "config": config}
    runs["start"] = start
    return runs


def test_tensorboard_tags_steps_and_scalars_match_jax(paired):
    jax_events, port_events = _events(paired["jax"]["dir"]), _events(paired["port"]["dir"])
    # images and scalars under the same tags at the same iterations; the
    # images of the same size (the JAX run logs no histograms without log_params)
    assert port_events["images"] == jax_events["images"]
    assert {t: [s for s, _ in v] for t, v in port_events["scalars"].items()} == \
        {t: [s for s, _ in v] for t, v in jax_events["scalars"].items()}
    assert port_events["histograms"] == jax_events["histograms"] == {}
    assert "val_0_predictions/batch_0/slice_4" in port_events["images"]
    assert port_events["scalars"]["train_loss_avg"][0][0] == 1
    # the loss, the eval score and the lr (StepLR stepped at the validation)
    # within 1e-4: the same arithmetic in f32, in other orders
    for tag in ("train_loss_avg", "val_loss_avg", "val_eval_score_avg", "learning_rate"):
        np.testing.assert_allclose([v for _, v in port_events["scalars"][tag]],
                                   [v for _, v in jax_events["scalars"][tag]], rtol=0, atol=1e-4, err_msg=tag)
    # 0.05 halved once, stored as a float32 scalar
    ((step, lr),) = port_events["scalars"]["learning_rate"]
    assert step == 2 and lr == pytest.approx(0.025, rel=1e-7)


def test_ema_and_accumulated_weights_match_the_jax_trainer(paired):
    # the checkpoints' EMA and raw weights within 1e-5 of their largest: one
    # f32 SGD trajectory in two frameworks
    cfg = paired["port"]["config"]["model"]
    got, want = {}, {}
    for ema in (True, False):
        for side, out in (("port", got), ("jax", want)):
            model = get_model(cfg)
            assert load_weights(model, os.path.join(paired[side]["dir"], "last_checkpoint.pytorch"), ema=ema) == ema
            out[ema] = {k: v.clone() for k, v in model.state_dict().items()}
    w_max = max(v.abs().max().item() for v in want[True].values())
    for ema in (True, False):
        for key, value in want[ema].items():
            torch.testing.assert_close(got[ema][key], value, rtol=0, atol=1e-5 * w_max, msg=f"ema={ema} {key}")
    assert any(not torch.equal(got[True][k], got[False][k]) for k in got[True])
    trainer = paired["port"]["trainer"]
    assert trainer.num_iterations == paired["jax"]["trainer"].num_iterations == 3


def test_port_ema_checkpoint_in_both_predict_paths(paired, tmp_path):
    """ROADMAP F8: the port's predict CLI predicts a port EMA checkpoint with
    its EMA weights; JAX predict3dunet reads only its model_state_dict."""
    path = os.path.join(paired["port"]["dir"], "last_checkpoint.pytorch")
    state = load_checkpoint(path)
    raw, ema = state["model_state_dict"], state["ema_state_dict"]
    assert set(ema) == {k for k, _ in get_model(MODEL).named_parameters()}
    jax_variables = jax_load_model_variables(jax_get_model(dict(MODEL)), path)
    for key, value in state_dict_from_jax(jax_variables).items():
        torch.testing.assert_close(value, raw[key], rtol=0, atol=0, msg=key)
    # the port's predict CLI: the EMA checkpoint predicts as its EMA weights do
    outputs = {}
    for name, weights in (("checkpoint", None), ("ema", {**raw, **ema}), ("raw", raw)):
        model_path = path if weights is None else str(tmp_path / f"{name}.pytorch")
        if weights is not None:
            torch.save(weights, model_path)
        out_dir = tmp_path / name
        out_dir.mkdir()
        predict_run({"device": "cpu", "model_path": model_path, "model": dict(MODEL),
                     "predictor": {"name": "StandardPredictor"},
                     "loaders": {"dataset": "StandardHDF5Dataset", "output_dir": str(out_dir), "batch_size": 1,
                                 "num_workers": 1, "raw_internal_path": "raw",
                                 "test": {"file_paths": [os.path.join(os.path.dirname(paired["start"]), "val.h5")],
                                          "slice_builder": {"name": "SliceBuilder", "patch_shape": list(CLI_PATCH),
                                                            "stride_shape": list(CLI_PATCH)},
                                          "transformer": {"raw": [{"name": "Standardize"},
                                                                  {"name": "ToTensor", "expand_dims": True}]}}}})
        import h5py

        with h5py.File(out_dir / "val_predictions.h5", "r") as f:
            outputs[name] = f["predictions"][:]
    np.testing.assert_array_equal(outputs["checkpoint"], outputs["ema"])
    assert np.abs(outputs["checkpoint"] - outputs["raw"]).max() > 0


# --- EMA ---------------------------------------------------------------------------------------------------------------


def test_ema_matches_the_float64_recurrence_and_validates_with_it(tmp_path):
    decay = 0.5
    batches = _batches(3, seed=4)
    trainer = create_trainer(_config(tmp_path, dict(SGD), ema_decay=decay, max_num_iterations=2),
                             loaders={"train": batches, "val": batches[:1]})
    params = list(trainer.model.parameters())
    seen = [[p.detach().double().clone() for p in params]]
    ema_step = trainer._ema_step
    trainer._ema_step = lambda: seen.append([p.detach().double().clone() for p in params]) or ema_step()
    trainer.fit()
    assert len(seen) == 4  # the start and 3 updates
    want = seen[0]
    for step in seen[1:]:
        want = [decay * e + (1 - decay) * p for e, p in zip(want, step)]
    # f32 EMA of f32 parameters against float64, within 1e-6 (values below 1)
    for got, expected in zip(trainer.ema, want):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), expected, rtol=0, atol=1e-6)
    assert any(not torch.equal(e, p.detach()) for e, p in zip(trainer.ema, params))
    # validation runs with the EMA weights and leaves the live ones, also when it raises
    live = [p.detach().clone() for p in params]
    with trainer._eval_weights():
        assert all(torch.equal(p, e) for p, e in zip(params, trainer.ema))
    with pytest.raises(RuntimeError), trainer._eval_weights():
        raise RuntimeError("validation failed")
    assert all(torch.equal(p, q) for p, q in zip(params, live))


@pytest.mark.parametrize("decay", [0.0, 1.0, 1.5, -0.1])
def test_ema_decay_outside_the_unit_interval_raises(tmp_path, decay):
    with pytest.raises(ValueError, match="ema_decay"):
        create_trainer(_config(tmp_path, dict(SGD), ema_decay=decay), loaders={"train": [], "val": []})


# --- gradient accumulation ----------------------------------------------------------------------------------------------


def test_accumulation_of_two_equals_the_batch2_step(tmp_path):
    b0, b1 = _batches(2, seed=6)
    stacked = tuple(np.concatenate([a, b]) for a, b in zip(b0, b1))
    runs = {}
    for name, batches, k in (("accum", [b0, b1], 2), ("batch2", [stacked], 1)):
        config = _config(tmp_path / name, dict(SGD), grad_accum_steps=k, max_num_iterations=10)
        # a per-voxel mean: the batch-2 loss is the mean of the two batch-1 losses
        config["loss"] = {"name": "BCEWithLogitsLoss", "skip_last_target": True}
        trainer = create_trainer(config, loaders={"train": batches, "val": []})
        losses = []
        criterion = trainer.loss_criterion
        trainer.loss_criterion = lambda logits, target: losses.append(criterion(logits, target)) or losses[-1]
        trainer.fit()
        runs[name] = (trainer, losses)
    (accum, accum_losses), (batch2, batch2_losses) = runs["accum"], runs["batch2"]
    assert accum.num_iterations == batch2.num_iterations == 2 and len(accum_losses) == 2
    # the parameters after one SGD update within 1e-6 of each other (f32
    # gradients summed in another order); the losses counted per microbatch
    for (name, p), q in zip(accum.model.named_parameters(), batch2.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=name)
    assert float(batch2_losses[0]) == pytest.approx(np.mean([float(v) for v in accum_losses]), rel=1e-6)


def test_trailing_group_is_dropped_and_batchnorm_moves_per_microbatch(tmp_path, caplog):
    model = {**MODEL, "layer_order": "bcr"}
    config = _config(tmp_path, dict(SGD), grad_accum_steps=2, max_num_iterations=10)
    config["model"] = model
    trainer = create_trainer(config, loaders={"train": _batches(3, seed=7), "val": []})
    with caplog.at_level(logging.INFO, logger="UNetTrainer"):
        trainer.fit()
    assert trainer.num_iterations == 2  # one update, then the epoch ends
    assert "Dropping trailing 1 microbatch(es) short of grad_accum_steps=2" in caplog.text
    counts = {int(b) for name, b in trainer.model.named_buffers() if name.endswith("num_batches_tracked")}
    assert counts == {2}


# --- resume and checkpoints -------------------------------------------------------------------------------------------


def test_resume_auto(tmp_path):
    """The contract of tests/test_trainer.py `test_resume_auto`: a fresh start
    without a checkpoint, then the same config picks last_checkpoint up."""
    batches = _batches(2, seed=8)
    config = _config(tmp_path, dict(SGD), resume="auto", validate_after_iters=2, max_num_iterations=2,
                     max_num_epochs=10)
    first = create_trainer(config, loaders={"train": batches, "val": batches[:1]})
    assert first.num_iterations == 1
    first.fit()
    assert os.path.exists(tmp_path / "last_checkpoint.pytorch")
    config["trainer"]["max_num_iterations"] = 4
    second = create_trainer(config, loaders={"train": batches, "val": batches[:1]})
    # the save at iteration 2 closed epoch 0 of two batches
    assert second.num_iterations == 3 and second.num_epochs == 1
    second.fit()
    assert second.num_iterations >= first.num_iterations


def test_async_checkpoint_writes_the_state_at_the_save(tmp_path, monkeypatch):
    batches = _batches(2, seed=9)
    trainer = create_trainer(_config(tmp_path, {"learning_rate": 1e-3}, ema_decay=0.9),
                             loaders={"train": batches, "val": []})
    trainer._update((batches[0],), RunningAverage())
    trainer._ema_step()
    # the background write waits until the next update has changed the
    # parameters, Adam's moments and the EMA in place
    gate, save = threading.Event(), port_trainer.save_checkpoint
    monkeypatch.setattr(port_trainer, "save_checkpoint",
                        lambda *args, **kwargs: gate.wait(timeout=60) and save(*args, **kwargs))
    trainer._save_checkpoint(is_best=False)
    at_save = copy.deepcopy(trainer._checkpoint_state())
    trainer._update((batches[1],), RunningAverage())
    trainer._ema_step()
    gate.set()
    trainer._wait_checkpoint()
    written = load_checkpoint(tmp_path / "last_checkpoint.pytorch")
    for key in ("model_state_dict", "ema_state_dict"):
        for name, value in at_save[key].items():
            torch.testing.assert_close(written[key][name], value, rtol=0, atol=0, msg=name)
    for index, state in at_save["optimizer_state_dict"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(written["optimizer_state_dict"]["state"][index][name], state[name],
                                       rtol=0, atol=0)
    assert not torch.equal(written["model_state_dict"]["final_conv.weight"], trainer.model.final_conv.weight)
    # async_checkpoint: false writes before the save returns
    trainer.async_checkpoint = False
    monkeypatch.setattr(port_trainer, "save_checkpoint", save)
    trainer._save_checkpoint(is_best=False)
    assert trainer._ckpt_future is None
    torch.testing.assert_close(load_checkpoint(tmp_path / "last_checkpoint.pytorch")["model_state_dict"]
                               ["final_conv.weight"], trainer.model.final_conv.weight.detach(), rtol=0, atol=0)


# the train transformer of resources/3DUnet_confocal_boundary_tpu/train_config.yml,
# which the device augmenter takes over
TPU_LOADERS = {"device_augment": True, "train": {"transformer": {
    "raw": [{"name": "Standardize"}, {"name": "RandomFlip"}, {"name": "RandomRotate90"},
            {"name": "RandomRotate", "axes": [[2, 1]], "angle_spectrum": 45, "mode": "reflect"},
            {"name": "ElasticDeformation", "spline_order": 3},
            {"name": "GaussianBlur3D", "execution_probability": 0.5},
            {"name": "AdditiveGaussianNoise", "execution_probability": 0.2},
            {"name": "AdditivePoissonNoise", "execution_probability": 0.2},
            {"name": "ToTensor", "expand_dims": True}],
    "label": [{"name": "RandomFlip"}, {"name": "RandomRotate90"},
              {"name": "RandomRotate", "axes": [[2, 1]], "angle_spectrum": 45, "mode": "reflect"},
              {"name": "ElasticDeformation", "spline_order": 0},
              {"name": "StandardLabelToBoundary", "append_label": True},
              {"name": "ToTensor", "expand_dims": False}]}}}


def _augmented_run(tmp, max_num_iterations, resume=None):
    """Train losses of the confocal `_tpu` recipe shrunk, with device
    augmentation and dropout, one host batch an epoch, a checkpoint at iteration 2."""
    rs = np.random.RandomState(10)
    label = _label(rs, (8, 32, 32)).astype(np.float32)
    raw = ((label % 3) + 0.5 * rs.randn(*label.shape)).astype(np.float32)
    host_batch = ((raw - raw.mean()) / raw.std())[None, None], label[None, None]
    config = _config(tmp, {"learning_rate": 1e-3}, validate_after_iters=2, max_num_iterations=max_num_iterations,
                     max_num_epochs=100, resume=resume)
    config["model"] = {**MODEL, "layer_order": "gcrd", "dropout_prob": 0.3}
    config["loaders"] = copy.deepcopy(TPU_LOADERS)
    val = (host_batch[0], _batches(1, seed=10)[0][1])
    trainer = create_trainer(config, loaders={"train": [host_batch], "val": [val]})
    losses = []
    criterion = trainer.loss_criterion

    def recording(logits, target):
        loss = criterion(logits, target)
        if torch.is_grad_enabled():
            losses.append(loss.item())
        return loss

    trainer.loss_criterion = recording
    trainer.fit()
    return trainer, losses


def test_resumed_run_replays_augmentation_and_dropout(tmp_path):
    """ROADMAP Queue 3: a run stopped after iteration 3 and resumed from its
    checkpoint at iteration 2 takes the uninterrupted run's losses, exactly
    (the same CPU arithmetic and the same draws)."""
    _, full = _augmented_run(tmp_path / "full", max_num_iterations=4)
    stopped, first = _augmented_run(tmp_path / "stopped", max_num_iterations=2)
    assert stopped.device_augmenter is not None and len(full) == 5 and len(first) == 3
    state = load_checkpoint(tmp_path / "stopped" / "last_checkpoint.pytorch")
    assert set(state["torch_rng_state"]) == {"cpu", "augment"}
    resumed, rest = _augmented_run(tmp_path / "resumed", max_num_iterations=4,
                                   resume=str(tmp_path / "stopped" / "last_checkpoint.pytorch"))
    np.testing.assert_array_equal(first, full[:3])
    np.testing.assert_array_equal(rest, full[2:])
    assert len(set(full)) == len(full)


def test_pre_trained_jax_npz_trains_as_its_torch_copy(tmp_path):
    """ROADMAP Queue 3: `pre_trained` reads a JAX npz's raw model_state_dict
    (not its EMA weights), as `train3dunet` does; two updates from it equal two
    from its `convert3dunet --to torch` copy, exactly."""
    from pytorch3dunet_tpu.convert import convert_checkpoint
    import jax

    _, variables = _jax_model_and_variables(MODEL, seed=11)
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, variables["params"])
    jax_save_checkpoint({"num_epochs": 1, "num_iterations": 1, "model_state_dict": variables, "ema_state_dict": ema,
                         "best_eval_score": 0.0, "optimizer_state_dict": None}, False, str(tmp_path / "jax"))
    npz = str(tmp_path / "jax" / "last_checkpoint.pytorch")
    copy_path = str(tmp_path / "copy.pytorch")
    assert convert_checkpoint({"model": dict(MODEL)}, npz, copy_path, to="torch") == "torch"
    batches = _batches(2, seed=12)
    trained = {}
    for name, path in (("npz", npz), ("copy", copy_path)):
        trainer = create_trainer(_config(tmp_path / name, dict(SGD), pre_trained=path, max_num_iterations=1),
                                 loaders={"train": batches, "val": []})
        for key, value in state_dict_from_jax(variables).items():
            torch.testing.assert_close(trainer.model.state_dict()[key], value, rtol=0, atol=0, msg=key)
        trainer.fit()
        trained[name] = trainer.model.state_dict()
    for key, value in trained["copy"].items():
        torch.testing.assert_close(trained["npz"][key], value, rtol=0, atol=0, msg=key)
    with pytest.raises(ValueError, match="convert3dunet"):
        create_trainer(_config(tmp_path / "resume", dict(SGD), resume=npz), loaders={"train": [], "val": []})


# --- remat, profiling, histograms ----------------------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    {"name": "UNet3D", "layer_order": "gcr"},
    {"name": "UNet3D", "layer_order": "bcr"},
    {"name": "ResidualUNet3D", "layer_order": "gcr"},
    {"name": "UNet3D", "layer_order": "gcrd", "dropout_prob": 0.3},
], ids=["gcr", "bcr", "ResidualUNet3D", "dropout"])
def test_remat_step_equals_the_plain_step(cfg):
    """The same ops on the same inputs in the recompute: gradients and
    BatchNorm's running statistics (moved once) equal the plain step's exactly."""
    results = {}
    x = torch.from_numpy(np.random.RandomState(13).randn(2, 1, 8, 16, 16).astype(np.float32))
    for remat in (False, True):
        torch.manual_seed(0)
        model = get_model({**cfg, "in_channels": 1, "out_channels": 2, "f_maps": 4, "num_groups": 2,
                           "num_levels": 2, "remat": remat}).train()
        torch.manual_seed(5)
        _, logits = model(x)
        logits.square().mean().backward()
        results[remat] = ({k: p.grad for k, p in model.named_parameters()}, dict(model.named_buffers()))
    (grads, buffers), (remat_grads, remat_buffers) = results[False], results[True]
    for key, value in grads.items():
        torch.testing.assert_close(remat_grads[key], value, rtol=0, atol=0, msg=key)
    for key, value in buffers.items():
        torch.testing.assert_close(remat_buffers[key], value, rtol=0, atol=0, msg=key)
    if cfg["layer_order"] == "bcr":
        assert {int(v) for k, v in remat_buffers.items() if k.endswith("num_batches_tracked")} == {1}


def test_profile_dir_and_log_params(tmp_path):
    batches = _batches(2, seed=14)
    profile_dir = tmp_path / "profile"
    trainer = create_trainer(_config(tmp_path, dict(SGD), profile_dir=str(profile_dir), log_params=True,
                                     log_after_iters=1, max_num_iterations=1), loaders={"train": batches, "val": []})
    trainer.fit()
    assert glob.glob(str(profile_dir / "*.pt.trace.json")) and trainer._profiler is None
    histograms = _events(str(tmp_path))["histograms"]
    names = [name for name, _ in trainer.model.named_parameters()]
    assert histograms == {tag: [1, 2] for name in names for tag in (name, f"{name}/grad")}


def test_2d_model_logs_its_images_with_z_restored(tmp_path):
    # (N, C, 1, H, W) batches of depth-1 patches: the train and validation
    # images of a UNet2D get their singleton z back before the formatter
    rs = np.random.RandomState(15)
    batch = (rs.randn(2, 1, 1, 32, 32).astype(np.float32), (rs.rand(2, 2, 1, 32, 32) > 0.5).astype(np.float32))
    config = _config(tmp_path, dict(SGD), validate_after_iters=1, log_after_iters=1, max_num_iterations=0,
                     tensorboard_formatter={"skip_last_target": True})
    config["model"] = {**MODEL, "name": "UNet2D"}
    trainer = create_trainer(config, loaders={"train": [batch], "val": [batch]})
    trainer.fit()
    images = _events(str(tmp_path))["images"]
    want = {f"{prefix}{name}/batch_{b}/slice_0": [(1, (32, 32))]
            for prefix in ("train_", "val_0_") for name in ("inputs", "targets", "predictions") for b in (0, 1)}
    assert images == want
