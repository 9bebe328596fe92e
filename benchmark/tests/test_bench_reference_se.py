"""The plain ResidualUNetSE3D (reference/models/ResidualUNetSE3D.py) and its
layer shapes (layers/ResidualUNetSE3D.py) against the port on the CPU at a
tiny size, on the same seeded weights: the forward, the parameters in the
state dict's order, and the port's device sweep against the plain sliding
window, which fails by at least ten times its tolerance with the scSE gates
skipped or with half of the patches left out; the tiny cell through the
harness; and the gates' readers on a hand-made trace. A new file, as
test_bench_reference.py names its families."""

import json

import pytest
import torch

from benchmark import harness, roofline, seeded
from benchmark.harness import Window
from benchmark.layers.ResidualUNetSE3D import se_bytes, se_layers
from benchmark.reference import models
from benchmark.reference import sweep as ref_sweep
from benchmark.tests.test_bench_faults import half_the_patches
from benchmark.tests.test_bench_trace import event
from benchmark.tests.tiny import write_tiny
from benchmark.trace import Trace

SEED = 2**31 + 77
CPU = torch.device("cpu")
CFG = {"name": "ResidualUNetSE3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 4,
       "num_levels": 3, "num_groups": 2, "final_sigmoid": True}
# f32 sums in another order: the probabilities and logits of a tiny model (test_bench_reference.py's)
TOL = 1e-5
CELL = "lightsheet_resunetse3d.sweep_grid_bf16"
# the tiny cell on the CPU in bf16: lightsheet_resunet3d's tiny limit (tiny.py), which the fault below fails
TINY_CELL = {"volume": [16, 24, 48], "pool": 2, "cells": 6, "limits": {"max_abs_gap": 0.03}}


def port_model(params):
    from pytorch3dunet_tpu_torch.models.unet import get_model

    model = get_model(CFG)
    model.load_state_dict(params, strict=True)
    return model.eval()


@pytest.mark.parametrize("shape", [(8, 24, 24), (12, 30, 34)])
def test_forward(shape):
    params = seeded.weights(CFG, SEED, CPU)
    x = torch.randn((1, 1, *shape), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want_p, want_l = port_model(params)(x)
        got_p, got_l = models.forward(params, x, CFG)
    assert got_l.shape == want_l.shape
    assert (got_l - want_l).abs().max() <= TOL * want_l.abs().max()
    assert (got_p - want_p).abs().max() <= TOL


def test_param_specs_are_the_state_dict_in_order():
    state = port_model(seeded.weights(CFG, SEED, CPU)).state_dict()
    assert models.param_specs(CFG) == [(k, tuple(v.shape)) for k, v in state.items()]


def _sweep(params, skip_gates=False):
    """The port's CPU device sweep of a tiny volume, the last patch of each axis flush, and the plain one."""
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path
    from pytorch3dunet_tpu_torch.models.se import ChannelSpatialSELayer3D
    from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor

    model = port_model(params)
    if skip_gates:
        for m in model.modules():
            if isinstance(m, ChannelSpatialSELayer3D):
                m.forward = lambda x: x
    volume = seeded.volumes((16, 24, 40), 1, SEED, CPU, cells=5)[0]
    patch, halo = (8, 16, 16), (2, 4, 4)
    assert len(ref_sweep.grid(volume.shape, patch, patch)) == 2 * 2 * 3
    normalize, stats = detect_device_path([{"name": "Standardize"}], calculate_stats(volume))
    got = DeviceSlidingWindowPredictor(model, None, 1, CPU).predict_array(volume, patch, patch, halo,
                                                                          normalize=normalize, stats=stats)
    return ref_sweep.max_gap(got, ref_sweep.predict(volume, params, CFG, patch, patch, halo, "assign", CPU))


def test_sweep():
    assert _sweep(seeded.weights(CFG, SEED, CPU)) <= TOL


def test_sweep_without_the_gates_fails():
    assert _sweep(seeded.weights(CFG, SEED, CPU), skip_gates=True) >= 10 * TOL


def test_sweep_of_half_the_patches_fails(monkeypatch):
    half_the_patches(monkeypatch)
    assert _sweep(seeded.weights(CFG, SEED, CPU)) >= 10 * TOL


@pytest.fixture(scope="module")
def tiny_se_root(tmp_path_factory):
    """The tiny cells (tiny.py, whose configurations include this one), and this cell at a tiny size."""
    root = write_tiny(tmp_path_factory.mktemp("tiny_se"))
    cell = json.loads((harness.ROOT / "workloads" / f"{CELL}.json").read_text())
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps({**cell, **TINY_CELL}))
    return root


@pytest.mark.parametrize("fault", [None, half_the_patches], ids=["sound", "half_the_patches"])
def test_tiny_cell(tiny_se_root, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    result = harness.run_cell(CELL, SEED, 0.5, False, CPU, root=tiny_se_root)
    assert set(result.compared) == {"max_abs_gap"} and result.attempted >= 1
    assert result.correct == (fault is None), result.compared


def test_se_layers_and_bytes():
    full = {**CFG, "f_maps": 32, "num_levels": None, "num_groups": 8}
    gates = se_layers(full, (112, 234, 234))
    assert [c for _, c, _ in gates] == [32, 64, 128, 256, 512, 256, 128, 64, 32]
    # the halo'd grid patch: 521.5 M gated elements a forward, 3.13 GB of least traffic in bf16 (the weights
    # 1.75 MB of it)
    assert sum(c * v for _, c, v in gates) == 521457664
    assert se_bytes(full, (112, 234, 234), "bfloat16") == 2 * (3 * 521457664 + sum(2 * c * c + 3 * c + 1
                                                                                   for _, c, _ in gates))
    # the gates' C->1 convs are the gates' (their read of x is in se_bytes), not the convs' yardstick
    assert roofline.conv_layers(full, (112, 234, 234)) == roofline.conv_layers({**full, "name": "ResidualUNet3D"},
                                                                               (112, 234, 234))


def test_gate_readers():
    """se_ms.grid reads the kernels inside `p3d.se` device spans per patch; se_roofline.grid puts the
    window's cell's gate bytes over that time; both read None without the spans."""
    cell = harness.load_cell(CELL)
    config = harness.load_config(cell["config"])
    recipe = config[cell["recipe"]]
    model_cfg = {**config["model"], "dtype": recipe["dtype"]}
    spatial = [p + 2 * h for p, h in zip(recipe["patch_shape"], recipe["halo_shape"])]
    work = roofline.conv_work(model_cfg, spatial, recipe["dtype"], count=27)
    events = [event("bench.window", "user_annotation", 0, 100), event("p3d.se", "user_annotation", 10, 1),
              event("p3d.se", "gpu_user_annotation", 20, 10), event("mean", "kernel", 20, 4),
              event("mul", "kernel", 25, 5), event("k2", "kernel", 31, 10)]
    window = Window("sweep", 1, 0, {}, patches=27, work=work,
                    trace=Trace.from_chrome({"traceEvents": events}, default_label="sweep.host"))
    se_ms = harness.metric_reader("se_ms.grid")(window)
    assert se_ms == pytest.approx(9 / 27)
    assert harness.metric_reader("se_roofline.grid")(window) == pytest.approx(
        100 * se_bytes(model_cfg, spatial, "bfloat16") / roofline.HBM_BYTES_PER_S / (se_ms / 1e3))
    other = Window("sweep", 1, 0, {}, patches=27, work=roofline.conv_work(model_cfg, spatial, None, count=27),
                   trace=window.trace)
    assert harness.metric_reader("se_roofline.grid")(other) is None
    bare = Window("sweep", 1, 0, {}, patches=27, work=work,
                  trace=Trace.from_chrome({"traceEvents": events[:1] + events[3:]}, default_label="sweep.host"))
    for name in ("se_ms.grid", "se_roofline.grid"):
        assert harness.metric_reader(name)(bare) is None
        assert harness.metric_reader(name)(Window("sweep", 1, 0, {}, patches=27, work=work)) is None
