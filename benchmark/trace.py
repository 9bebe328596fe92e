"""The traced window: torch.profiler around the measured window of a
`--trace 1` run, read back from its Chrome trace.

`Tracer` opens the host ranges (`record_function`) that the traffic drivers
name around their calls into the program (`sweep.predict_array`,
`train.prepare_batch`, ...), and, on a model it is handed, one range per
encoder and decoder level (`encoder.<i>`, `decoder.<i>`) by forward hooks.
Without `--trace 1` every range is a null context and no hook is set.

`Trace` holds what the metric readers take from the trace: the device's
kernels, copies and memsets, the host ranges, and the window itself (the
`bench.window` range the tracer opens at the window's start and closes after
the closing synchronize).
"""

import bisect
import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import torch

WINDOW_RANGE = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Event:
    name: str
    cat: str
    start: float  # seconds, on the trace's clock
    end: float


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    device: list[Event]
    ranges: list[Event]
    gpu_ranges: list[Event]
    window: tuple[float, float] = (0.0, 0.0)
    default_label: str = "host"

    @classmethod
    def from_chrome(cls, trace: dict, default_label: str = "host") -> "Trace":
        device, ranges, gpu_ranges = [], [], []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            start = float(e["ts"]) * 1e-6
            ev = Event(e.get("name", ""), cat, start, start + float(e["dur"]) * 1e-6)
            if cat in DEVICE_CATS:
                device.append(ev)
            elif cat == "user_annotation":
                ranges.append(ev)
            elif cat == "gpu_user_annotation":
                gpu_ranges.append(ev)
        windows = [r for r in ranges if r.name == WINDOW_RANGE]
        window = (windows[0].start, windows[0].end) if windows else (
            min((e.start for e in device), default=0.0), max((e.end for e in device), default=0.0))
        return cls(device, [r for r in ranges if r.name != WINDOW_RANGE], gpu_ranges, window, default_label)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, cats=DEVICE_CATS) -> list[Event]:
        lo, hi = self.window
        return [e for e in self.device if e.cat in cats and e.end > lo and e.start < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or memset ran."""
        return union_length([(e.start, e.end) for e in self.in_window()], *self.window)

    def by_name(self, cats=DEVICE_CATS) -> dict[str, float]:
        """Device seconds by operation name, in the window."""
        out: dict[str, float] = {}
        for e in self.in_window(cats):
            out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
        return out

    @staticmethod
    def _labeller(ranges, default):
        """label(t): the innermost of `ranges` (the latest opened) open at
        host time t, or `default`; the timeline is cut once where a range
        opens or closes."""
        edges = sorted([(r.start, 1, i) for i, r in enumerate(ranges)] + [(r.end, 0, i) for i, r in enumerate(ranges)])
        starts, labels, active = [float("-inf")], [default], {}
        for t, opening, i in edges:
            if opening:
                active[i] = ranges[i].start
            else:
                active.pop(i, None)
            starts.append(t)
            labels.append(ranges[max(active, key=active.get)].name if active else default)
        return lambda t: labels[bisect.bisect_right(starts, t) - 1]

    def idle_by_label(self, short: float = 20e-6) -> dict[str, float]:
        """Idle device seconds of the window, by the host range open at each
        gap's middle; gaps under `short` (launch to launch) as 'short_gaps'."""
        label_at = self._labeller(self.ranges, self.default_label)
        out: dict[str, float] = {}
        for a, b in gaps([(e.start, e.end) for e in self.in_window()], *self.window):
            label = "short_gaps" if b - a < short else label_at((a + b) / 2)
            out[label] = out.get(label, 0.0) + (b - a)
        return out

    def range_device_s(self, prefix: str) -> dict[str, float] | None:
        """Kernel seconds inside the device span the profiler gives each host
        range whose name starts with `prefix` (`gpu_user_annotation`: one
        stream runs the kernels in launch order, so the kernels inside a
        range's span are its own), by range name; None when no kernel is in one."""
        lo, hi = self.window
        spans = sorted((r for r in self.gpu_ranges if r.name.startswith(prefix) and r.end > lo and r.start < hi),
                       key=lambda r: r.start)
        if not spans:
            return None
        starts, out = [r.start for r in spans], {}
        for k in self.in_window(("kernel",)):
            i = bisect.bisect_right(starts, k.start) - 1
            if i >= 0 and k.end <= spans[i].end:
                out[spans[i].name] = out.get(spans[i].name, 0.0) + (k.end - k.start)
        return out or None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_label().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}


class Tracer:
    """Host ranges, model hooks and the profiler of one run (see the module docstring)."""

    def __init__(self, enabled: bool, kind: str):
        self.enabled = enabled
        self.kind = kind
        self._prof = None
        self._window_range = None
        self._t0 = None
        self._hooks = []

    @staticmethod
    def note(what: str):
        """A set-up step's end on standard error, in seconds since the process started."""
        from benchmark.harness import process_age_s

        print(f"setup: {what} at {process_age_s():.2f} s", file=sys.stderr, flush=True)

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def hook_model(self, model):
        """One range per encoder and decoder level of `model`, opened by forward hooks."""
        if not self.enabled:
            return
        for prefix, modules in (("encoder", model.encoders), ("decoder", model.decoders)):
            for i, module in enumerate(modules):
                stack = []

                def pre(_m, _inp, name=f"{prefix}.{i}", stack=stack):
                    rf = torch.profiler.record_function(name)
                    rf.__enter__()
                    stack.append(rf)

                def post(_m, _inp, _out, stack=stack):
                    stack.pop().__exit__(None, None, None)

                self._hooks += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def unhook(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def start(self):
        """The window's start: the profiler (in a traced run) and the host clock."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._window_range = torch.profiler.record_function(WINDOW_RANGE)
            self._window_range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, synchronize) -> float:
        """The window's end after `synchronize()`; returns its seconds on the host clock."""
        synchronize()
        seconds = time.perf_counter() - self._t0
        if self.enabled:
            self._window_range.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.unhook()
        return seconds

    def read(self) -> Trace | None:
        """Reads the profiler's trace back (after the window; not timed)."""
        if not self.enabled or self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        self._prof = None
        return Trace.from_chrome(raw, default_label=f"{self.kind}.host")
