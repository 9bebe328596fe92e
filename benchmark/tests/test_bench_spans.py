"""The readers of the program's own spans (spans.py and the metrics that read
`p3d.*` ranges) on a hand-made Chrome trace: kernel time inside the norm
spans' device spans, host time of a span clipped to the window, per patch,
volume or update; a norm span nested in the middle of an encoder level
leaves `encoder_ms` as it was, and one that opens the level takes its kernels
out of `encoder_ms` (the profiler gives each kernel to the innermost range);
a trace of a program that opens no span reads None."""

import pytest

from benchmark import harness
from benchmark.harness import Window
from benchmark.trace import Trace
from benchmark.tests.test_bench_trace import event

HOOKS = [
    event("bench.window", "user_annotation", 0, 100),
    event("sweep.stats", "user_annotation", 1, 12),
    event("sweep.predict_array", "user_annotation", 13, 77),
    event("encoder.0", "user_annotation", 14, 16),
    event("encoder.0", "gpu_user_annotation", 20, 30),
    event("k2", "kernel", 20, 10),
    event("rowwise_moments", "kernel", 30, 8),
    event("cast", "kernel", 38, 2),
    event("k2", "kernel", 40, 10),
    event("fused_stats", "kernel", 55, 4),
    event("train.prepare_batch", "user_annotation", 91, 4),
]
SPANS = [
    event("p3d.stats", "user_annotation", 2, 10),
    event("p3d.stats", "user_annotation", 96, 14),  # runs past the window's end: 4 ms inside
    event("p3d.norm.group", "user_annotation", 15, 2),  # inside encoder.0
    event("p3d.norm.group", "gpu_user_annotation", 30, 10),
    event("p3d.norm.fused", "user_annotation", 32, 1),
    event("p3d.norm.fused", "gpu_user_annotation", 55, 5),
    event("p3d.trainer.prepare_batch", "user_annotation", 92, 3),
    event("p3d.trainer.step", "user_annotation", 80, 6),
]


def _window(kind, traced_events, attempted=2, patches=4):
    trace = Trace.from_chrome({"traceEvents": traced_events}, default_label=f"{kind}.host")
    return Window(kind, attempted, 0, {}, patches=patches, trace=trace)


def _read(name, window):
    return harness.metric_reader(name)(window)


def test_norm_and_stats_of_a_sweep():
    window = _window("sweep", HOOKS + SPANS)
    # rowwise_moments 8 + cast 2 inside p3d.norm.group, fused_stats 4 inside p3d.norm.fused, over 4 patches
    assert _read("norm_ms.sweep", window) == pytest.approx(14 / 4)
    assert _read("norm_ms.grid", window) == pytest.approx(14 / 4)
    # 10 ms and the 4 ms inside the window, over 2 volumes
    assert _read("stats_ms.sweep", window) == pytest.approx(14 / 2)
    assert _read("stats_ms.grid", window) == pytest.approx(14 / 2)
    # the idle stretch 0-20 ms (middle 10) is put down to the innermost range, the program's span
    assert window.trace.idle_by_label()["p3d.stats"] == pytest.approx(20e-3)
    for name in ("norm_ms.train", "prepare_ms.train", "step_host_ms.train"):
        assert _read(name, window) is None


def test_a_norm_span_inside_an_encoder_level_leaves_encoder_ms():
    alone, nested = _window("sweep", HOOKS), _window("sweep", HOOKS + SPANS)
    assert _read("encoder_ms.sweep", nested) == _read("encoder_ms.sweep", alone) == pytest.approx(30 / 4)


def _leading_norm(nested):
    """encoder.0 whose first op is a GroupNorm: rowwise_moments 20-28, then k2 28-38 and relu 38-39.5. The
    profiler gives the norm's kernel to the innermost range, so with the norm's span the level's device span
    starts after it."""
    level = [event("bench.window", "user_annotation", 0, 100),
             event("encoder.0", "user_annotation", 14, 4),
             event("rowwise_moments", "kernel", 20, 8), event("k2", "kernel", 28, 10), event("relu", "kernel", 38, 1.5)]
    if not nested:
        return level + [event("encoder.0", "gpu_user_annotation", 20, 20)]
    return level + [event("p3d.norm.group", "user_annotation", 14.1, 0.4),
                    event("p3d.norm.group", "gpu_user_annotation", 20, 8),
                    event("encoder.0", "gpu_user_annotation", 28, 12)]


def test_a_norm_span_that_opens_a_level_takes_its_kernels_out_of_encoder_ms():
    alone, nested = _window("sweep", _leading_norm(False)), _window("sweep", _leading_norm(True))
    assert _read("encoder_ms.sweep", alone) == pytest.approx(19.5 / 4)
    assert _read("encoder_ms.sweep", nested) == pytest.approx(11.5 / 4)
    assert _read("norm_ms.sweep", nested) == pytest.approx(8 / 4)


def test_trainer_spans_per_update():
    window = _window("train", HOOKS + SPANS)
    assert _read("prepare_ms.train", window) == pytest.approx(3 / 2)
    assert _read("step_host_ms.train", window) == pytest.approx(6 / 2)
    assert _read("norm_ms.train", window) == pytest.approx(14 / 2)
    assert _read("stats_ms.sweep", window) is None


@pytest.mark.parametrize("name", ["norm_ms.sweep", "norm_ms.grid", "stats_ms.sweep", "stats_ms.grid",
                                  "norm_ms.train", "prepare_ms.train", "step_host_ms.train"])
def test_a_program_without_spans_reads_none(name):
    for kind in ("sweep", "train"):
        assert _read(name, _window(kind, HOOKS)) is None
        assert _read(name, Window(kind, 2, 0, {}, patches=4)) is None
