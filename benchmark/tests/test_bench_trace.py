"""trace.py on a hand-made Chrome trace: the window from its range, the busy
time as a union (overlaps once), idle gaps by the innermost host range, and
kernel time by the device spans of host ranges."""

import pytest

from benchmark.trace import Trace


def event(name, cat, ts_ms, dur_ms):
    return {"ph": "X", "name": name, "cat": cat, "ts": 1e3 * ts_ms, "dur": 1e3 * dur_ms}


TRACE = {"traceEvents": [
    event("bench.window", "user_annotation", 0, 100),
    event("sweep.predict_array", "user_annotation", 11, 79),
    event("encoder.0", "user_annotation", 12, 10),
    event("encoder.0", "gpu_user_annotation", 20, 20),
    event("k2", "kernel", 20, 10),
    event("gn", "kernel", 25, 10),  # overlaps k2 by 5
    event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 50, 10),
    event("late", "kernel", 95, 10),  # runs past the window's end
    event("outside", "kernel", 200, 10),
    {"ph": "i", "name": "marker", "ts": 5000},
    event("tiny gap before", "kernel", 60.005, 0.001),
]}


def test_trace():
    t = Trace.from_chrome(TRACE, default_label="sweep.host")
    assert t.window == pytest.approx((0.0, 100e-3))
    assert t.busy_s() == pytest.approx((15 + 10 + 5 + 0.001) * 1e-3)
    idle = t.idle_by_label()
    # gaps: 0-20 (middle 10: the window's start, no range yet), 35-50 (inside predict_array), 60-60.005
    # (short), 60.006-95 (middle 77.5)
    assert idle == pytest.approx({"sweep.host": 20e-3, "sweep.predict_array": 15e-3 + 34.994e-3,
                                  "short_gaps": 5e-6})
    assert t.range_device_s("encoder.") == pytest.approx({"encoder.0": 20e-3})
    assert t.range_device_s("decoder.") is None
    assert t.by_name(("gpu_memcpy",)) == pytest.approx({"Memcpy HtoD (Pageable -> Device)": 10e-3})
    breakdown = t.breakdown()
    assert dict(breakdown["device_ops"])["k2"] == pytest.approx(10e-3)
    assert dict(breakdown["idle_gaps"]) == pytest.approx(idle)
