"""The port's profiler spans (`utils/misc.py` `span`, every one named `p3d.*`),
the trainer's logged throughput and the server's request counters, on the CPU
with tiny models and volumes: no card and no JAX.

Under a CPU `torch.profiler` each span is a host range of the trace (the
benchmark's per-layer metrics read them in its traced runs); with no profiler
the helper makes no `record_function`, and a traced export keeps none.
"""

import io
import json
import logging
import threading
import types
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch3dunet_tpu_torch import trainer as port_trainer
from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
from pytorch3dunet_tpu_torch.export import export_model, load_exported
from pytorch3dunet_tpu_torch.models.unet import get_model
from pytorch3dunet_tpu_torch.predictor import DeviceSlidingWindowPredictor
from pytorch3dunet_tpu_torch.serve import STAGES, ServingSession, make_server
from pytorch3dunet_tpu_torch.trainer import create_trainer
from pytorch3dunet_tpu_torch.utils.misc import span

MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "layer_order": "gcr", "f_maps": 8,
         "num_groups": 4, "num_levels": 2, "final_sigmoid": True}
# the decoder's skip is an exact 2x of its input: the fused decoder takes it
PATCH = (8, 32, 32)
VOXELS = int(np.prod(PATCH))


def _model():
    torch.manual_seed(0)
    return get_model(dict(MODEL)).eval()


def _recorded(fn) -> set:
    """The names of the host ranges `fn()` records under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _trainer(tmp_path, n_batches, **trainer):
    rs = np.random.RandomState(0)
    batches = [(rs.rand(1, 1, *PATCH).astype(np.float32), (rs.rand(1, 1, *PATCH) > 0.5).astype(np.float32))
               for _ in range(n_batches)]
    config = {"device": "cpu", "manual_seed": 0, "model": dict(MODEL), "loss": {"name": "BCEDiceLoss"},
              "eval_metric": {"name": "DiceCoefficient"}, "optimizer": {"name": "SGD", "learning_rate": 0.01},
              "trainer": {"checkpoint_dir": str(tmp_path), "validate_after_iters": 10**6, "log_after_iters": 10**6,
                          "max_num_epochs": 1, "max_num_iterations": 100, "skip_train_validation": True, **trainer}}
    return create_trainer(config, loaders={"train": batches, "val": []})


def test_forward_records_the_group_and_the_fused_norms():
    model, x = _model(), torch.rand(1, 1, *PATCH)
    assert model.decoders[0].fused_mode(tuple(model.encoders[0](x).shape), (1, 16, 4, 16, 16)) == "full"
    with torch.no_grad():
        names = _recorded(lambda: model(x))
    assert {"p3d.norm.group", "p3d.norm.fused"} <= names


def test_predict_array_and_calculate_stats_record_their_spans():
    predictor = DeviceSlidingWindowPredictor(_model(), None, 1, "cpu")
    volume = np.random.RandomState(1).rand(8, 40, 40).astype(np.float32)
    names = _recorded(lambda: predictor.predict_array(volume, PATCH, PATCH, (2, 4, 4)))
    assert "p3d.norm.group" in names and "p3d.stats" not in names
    assert "p3d.stats" in _recorded(lambda: calculate_stats(volume))
    assert "p3d.stats" not in _recorded(lambda: calculate_stats(volume, skip=True))


def test_trainer_update_records_batch_and_step(tmp_path):
    trainer = _trainer(tmp_path, 1)
    names = _recorded(trainer.fit)
    assert {"p3d.trainer.prepare_batch", "p3d.trainer.step"} <= names


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert span("p3d.a") is span("p3d.b")
    model, x = _model(), torch.rand(1, 1, *PATCH)
    with torch.no_grad():
        model(x)
    predictor = DeviceSlidingWindowPredictor(model, None, 1, "cpu")
    predictor.predict_array(np.zeros((8, 32, 32), np.float32), PATCH, PATCH, (0, 0, 0))
    calculate_stats(np.zeros(PATCH, np.float32))


def test_export_under_the_profiler_keeps_no_profiler_op(tmp_path):
    path = tmp_path / "m.u3dx"
    with profile(activities=[ProfilerActivity.CPU]):
        export_model({"device": "cpu", "model": dict(MODEL)}, output_path=str(path), patch_shape=PATCH, batch=1)
    targets = [str(node.target) for node in load_exported(path).program.graph.nodes]
    assert any("conv3d_fwd" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


def test_throughput_is_the_voxels_since_the_last_log_over_its_wall_seconds(tmp_path, monkeypatch, caplog):
    clock = [0.0]
    monkeypatch.setattr(port_trainer, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
    trainer = _trainer(tmp_path, 4, log_after_iters=2)
    trainer.writer = mock.MagicMock()
    update, durations = trainer._update, iter([1e-3, 3e-3, 4e-3, 4e-3])

    def timed_update(group, losses):
        out = update(group, losses)
        clock[0] += next(durations)
        return out

    trainer._update = timed_update
    with caplog.at_level(logging.INFO, logger="UNetTrainer"):
        trainer.fit()
    rates = [c.args[1:] for c in trainer.writer.add_scalar.call_args_list if c.args[0] == "train_voxels_per_sec"]
    # 2 updates a log: 1 + 3 ms, then 4 + 4 ms (an average of the per-update rates would read 5.46 and 2.05 M)
    assert rates == [(pytest.approx(2 * VOXELS / 4e-3), 2), (pytest.approx(2 * VOXELS / 8e-3), 4)]
    assert "Throughput: 4.10 Mvoxels/s" in caplog.text and "Throughput: 2.05 Mvoxels/s" in caplog.text


def test_info_counts_each_stage_of_two_requests():
    config = {"device": "cpu", "model": dict(MODEL), "predictor": {"name": "DeviceSlidingWindowPredictor"},
              "loaders": {"test": {"slice_builder": {"patch_shape": list(PATCH), "halo_shape": [0, 0, 0]},
                                   "transformer": {"raw": [{"name": "Standardize"}, {"name": "ToTensor"}]}}}}
    session = ServingSession(config)
    server = make_server(session, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for seed in (2, 3):
            buf = io.BytesIO()
            np.save(buf, np.random.RandomState(seed).rand(*PATCH).astype(np.float32))
            req = urllib.request.Request(f"{base}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert np.load(io.BytesIO(resp.read())).shape == (1, *PATCH)
        with urllib.request.urlopen(f"{base}/info", timeout=60) as resp:
            info = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert info["requests_served"] == 2
    assert set(info["stages"]) == set(STAGES)
    for stage in info["stages"].values():
        assert stage["count"] == 2 and stage["seconds"] >= 0
    assert info["stages"]["predict"]["seconds"] > 0
