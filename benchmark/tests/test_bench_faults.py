"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: a sound run comes
out correct, and each fault the cell can have makes `correct` false.

Faults: an answer altered where it is produced (one probability of a sweep's
or a served reply's output; one parameter's update of a train step); half of
the work left out (half of a sweep's patches; half of each train batch, the
loss the mean over the rest); a train step that leaves its state unchanged."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import TINY_LIMITS

SEED = 2**31 + 9
CPU = torch.device("cpu")


def run(root, cell):
    result = harness.run_cell(cell, SEED, 0.5, False, CPU, root=root)
    assert set(result.compared) == set(TINY_LIMITS[cell])
    return result


def altered_answer(monkeypatch):
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor

    original = DeviceSlidingWindowPredictor.predict_array

    def altered(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        out[(0,) * out.ndim] += 0.05
        return out

    monkeypatch.setattr(DeviceSlidingWindowPredictor, "predict_array", altered)


def half_the_patches(monkeypatch):
    from pytorch3dunet_tpu_torch.inference_device import DeviceSlidingWindow

    original = DeviceSlidingWindow._accumulate
    monkeypatch.setattr(DeviceSlidingWindow, "_accumulate",
                        lambda self, volume, starts, stats: original(self, volume, starts[::2], stats))


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_the_batch(monkeypatch):
    """The forward whole, the loss taken over the first half of each batch's depth."""
    from pytorch3dunet_tpu_torch.losses import BCEDiceLoss

    original = BCEDiceLoss.__call__

    def half(self, input, target):
        d = input.shape[2] // 2
        return original(self, input[:, :, :d], target[:, :, :d])

    monkeypatch.setattr(BCEDiceLoss, "__call__", half)


def altered_update(monkeypatch):
    original = torch.optim.Adam.step

    def step(self, closure=None):
        first = self.param_groups[0]["params"][-1]
        first.grad.mul_(3.0)
        return original(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", step)


CELLS = ["confocal_unet3d.sweep_gaussian", "lightsheet_resunet3d.sweep_grid_bf16", "confocal_unet3d.train_bf16",
         "confocal_unet3d.serve"]
FAULTS = [("confocal_unet3d.sweep_gaussian", altered_answer), ("confocal_unet3d.sweep_gaussian", half_the_patches),
          ("lightsheet_resunet3d.sweep_grid_bf16", altered_answer),
          ("lightsheet_resunet3d.sweep_grid_bf16", half_the_patches),
          ("confocal_unet3d.train_bf16", unchanged_state), ("confocal_unet3d.train_bf16", half_the_batch),
          ("confocal_unet3d.train_bf16", altered_update), ("confocal_unet3d.serve", altered_answer)]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result = run(tiny_root, cell)
    assert result.correct, result.compared
    assert result.attempted >= 1 and result.failed == 0


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = run(tiny_root, cell)
    assert not result.correct, result.compared
    assert np.isfinite([c["value"] for c in result.compared.values()]).any()
