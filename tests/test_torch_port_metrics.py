"""The device twins of the eval metrics (pytorch3dunet_tpu_torch/metrics.py
`device_metric_fn`) against the JAX package's twins (channels-last) and the
port's own host metrics, on the same seeded arrays, and the trainer's
validation with a twin: the same score as the host metric, and no host sync
inside its loop."""

import numpy as np
import pytest
import torch

from pytorch3dunet_tpu import metrics as jax_metrics
from pytorch3dunet_tpu_torch import metrics
from pytorch3dunet_tpu_torch.trainer import UNetTrainer, create_trainer

SPATIAL = (4, 6, 5)
# a twin sums in f32 on the device, the host metric in float64
TOL = 1e-6


def _probs(seed, channels, n=2):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, channels, *SPATIAL).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum(1, keepdims=True) if channels > 1 else 1 / (1 + np.exp(-logits))


def _both_twins(name, kwargs, probs, target):
    """(port twin, JAX twin, port host metric) of the same arrays."""
    criterion = getattr(metrics, name)(**kwargs)
    twin = metrics.device_metric_fn(criterion)
    jax_twin = jax_metrics.device_metric_fn(getattr(jax_metrics, name)(**kwargs))
    got = twin(torch.from_numpy(probs), torch.from_numpy(target))
    assert got.ndim == 0 and got.dtype == torch.float32
    jax_target = np.moveaxis(target, 1, -1) if target.ndim == probs.ndim else target
    want = float(jax_twin(np.moveaxis(probs, 1, -1), jax_target))
    return got.item(), want, criterion(probs, target)


def _class_map(seed, channels, n=2):
    return np.random.RandomState(seed).randint(0, channels, (n, *SPATIAL)).astype(np.int64)


CASES = {
    "dice": ("DiceCoefficient", {}, lambda: (_probs(0, 3), (_probs(1, 3) > 0.4).astype(np.float32))),
    "dice one channel": ("DiceCoefficient", {"epsilon": 1e-4}, lambda: (_probs(2, 1),
                                                                         (_probs(3, 1) > 0.5).astype(np.float32))),
    "mean_iou channelwise": ("MeanIoU", {}, lambda: (_probs(4, 2), (_probs(5, 2) > 0.5).astype(np.float32))),
    "mean_iou class map": ("MeanIoU", {}, lambda: (_probs(6, 3), _class_map(7, 3))),
    "mean_iou class map with background": ("MeanIoU", {"skip_background": False},
                                           lambda: (_probs(8, 3), _class_map(9, 3))),
    "mse": ("MSE", {}, lambda: (_probs(10, 1), _probs(11, 1))),
    "psnr range 1": ("PSNR", {}, lambda: (_probs(12, 1), _probs(13, 1))),
    "psnr range 2": ("PSNR", {}, lambda: (_probs(14, 1), _probs(15, 1) * 2 - 1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax_twin_and_host_metric(case):
    name, kwargs, arrays = CASES[case]
    got, want, host = _both_twins(name, kwargs, *arrays())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, host, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("skip_background", [True, False])
def test_mean_iou_argmax_ties_take_the_first_class(skip_background):
    # every voxel ties between classes 1 and 2 (and half of them with 0):
    # torch.argmax, jnp.argmax and np.argmax all take the first maximum
    probs = np.zeros((1, 3, *SPATIAL), dtype=np.float32)
    probs[:, 1:] = 0.5
    probs[:, 0, ::2] = 0.5
    target = _class_map(16, 3, n=1)
    got, want, host = _both_twins("MeanIoU", {"skip_background": skip_background}, probs, target)
    assert got == pytest.approx(want, abs=TOL) and got == pytest.approx(host, abs=TOL)
    pred = torch.from_numpy(probs).argmax(dim=1).numpy()
    np.testing.assert_array_equal(pred, probs.argmax(axis=1))
    assert set(np.unique(pred)) == {0, 1}


def test_psnr_at_zero_error_is_inf_on_both_paths():
    probs = _probs(17, 1)
    got, want, host = _both_twins("PSNR", {}, probs, probs.copy())
    assert got == want == host == float("inf")
    # the validation's running average takes it, as the JAX trainer's does
    losses, scores = UNetTrainer._averages([(torch.tensor(0.5), torch.tensor(got), 1),
                                            (torch.tensor(0.7), torch.tensor(20.0), 1)])
    assert losses.avg == pytest.approx(0.6) and scores.avg == float("inf")


@pytest.mark.parametrize("name,kwargs", [
    ("BoundaryAdaptedRandError", {"threshold": 0.4, "use_last_target": True}),
    ("AdaptedRandError", {}),
    ("GenericAdaptedRandError", {"input_channels": [0]}),
    ("BlobsAveragePrecision", {}),
    ("BoundaryAveragePrecision", {}),
])
def test_host_algorithm_metrics_have_no_twin(name, kwargs):
    assert metrics.device_metric_fn(getattr(metrics, name)(**kwargs)) is None
    assert jax_metrics.device_metric_fn(getattr(jax_metrics, name)(**kwargs)) is None


# --- validation through the trainer ------------------------------------------------------------------------------


def _trainer(tmp_path, eval_metric):
    """The multiclass recipe (CrossEntropyLoss, a class-map target) shrunk,
    with 3 in-memory validation batches."""
    rs = np.random.RandomState(18)
    val = [(rs.randn(1, 1, 8, 16, 16).astype(np.float32), rs.randint(0, 3, (1, 8, 16, 16)).astype(np.int64))
           for _ in range(3)]
    config = {"device": "cpu", "manual_seed": 0,
              "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 3, "layer_order": "gcr", "f_maps": 8,
                        "num_groups": 4, "num_levels": 2, "final_sigmoid": False},
              "loss": {"name": "CrossEntropyLoss"}, "eval_metric": eval_metric,
              "optimizer": {"learning_rate": 2e-4},
              "trainer": {"checkpoint_dir": str(tmp_path), "validate_after_iters": 1, "log_after_iters": 1,
                          "max_num_epochs": 1, "max_num_iterations": 1,
                          # no validation images: those batches go to the host metric
                          # (JAX test_trainer.py `test_device_metric_validation_path`)
                          "max_val_images": 0}}
    return create_trainer(config, loaders={"train": [], "val": val})


@pytest.mark.parametrize("skip_background", [True, False])
def test_validation_with_the_twin_equals_the_host_metric(tmp_path, skip_background):
    trainer = _trainer(tmp_path, {"name": "MeanIoU", "skip_background": skip_background})
    assert trainer.device_metric is not None
    with_twin = trainer.validate()
    trainer.device_metric = None
    assert with_twin == pytest.approx(trainer.validate(), abs=TOL)


def test_validation_with_a_twin_makes_no_host_sync(tmp_path, monkeypatch):
    # inside the loop no tensor goes to the host: .item/.cpu/.tolist/.numpy
    # and float() raise there; the pending scores are read after it
    trainer = _trainer(tmp_path, {"name": "MeanIoU"})

    def refuse(*args, **kwargs):
        raise AssertionError("host sync inside the validation loop")

    read = []
    averages = trainer._averages

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy", "__float__"):
            m.setattr(torch.Tensor, name, refuse)

        def after_the_loop(pending):
            read.append(len(pending))
            m.undo()
            return averages(pending)

        m.setattr(trainer, "_averages", after_the_loop)
        score = trainer.validate()
    assert read == [3] and 0 <= score <= 1
