"""The result line and the exits of `benchmark/run.py`: the line's keys and
their order (`compared` last), its metrics with their units, the traced run's
device fields and breakdown, a cell file the harness was not told about, and
the runs that must end without a result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness

CHECKOUT = Path(__file__).resolve().parents[2]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
CELL = "confocal_unet3d.sweep_gaussian"


@pytest.mark.parametrize("trace", [False, True])
def test_line(tiny_root, trace):
    result = harness.run_cell(CELL, 2**31 + 3, 0.5, trace, torch.device("cpu"), root=tiny_root)
    line = json.loads(result.line())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert all(set(c) >= {"value", "limit"} for c in line["compared"].values())
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name, metric in line["metrics"].items():
        assert set(metric) == {"value", "unit"} and metric["unit"] == units[name]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert "predict_vox_s" not in line["metrics"]
    else:
        assert set(line["metrics"]) == {"predict_vox_s", "peak_gib", "setup_s"}


def test_cell_the_harness_was_not_told_of(tiny_root):
    cell = json.loads((tiny_root / "workloads" / f"{CELL}.json").read_text())
    (tiny_root / "workloads" / "confocal_unet3d.sweep_new.json").write_text(json.dumps(cell))
    result = harness.run_cell("confocal_unet3d.sweep_new", 2**31 + 4, 0.2, False, torch.device("cpu"), root=tiny_root,
                              bench={})
    assert result.correct and "predict_vox_s" in result.metrics


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_benchmark_alone_is_no_program(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_found():
    assert harness.forbidden_loaded(["pytorch3dunet_tpu_torch", "pytorch3dunet_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "torch", "pytorch3dunet_tpu.models"]) == ["jax", "pytorch3dunet_tpu"]
