"""What every cell shares: finding a cell and its configuration by name,
running the traffic driver's set-up, window and check, reading the per-layer
metrics, and the result line.

Everything is found by name, so a later cell, configuration or metric is a
new file and never an edit:
- `workloads/<cell>.json`: the cell (its configuration, traffic `kind`,
  traffic parameters, `chips`, `why`, and the check's `limits`);
- `configs/<config>.json`: the configuration (the model and the recipe
  sections it is run with);
- `traffic/<kind>.py`: the driver of a traffic kind, with `setup`, `window`
  and `check`;
- `metrics/<metric>.py`: the reader of a per-layer metric, `read(window)`,
  which returns None when the run gives it nothing to read;
- `layers/<model name>.py`: the conv shapes that roofline.py counts.
Which per-layer metrics a cell reports comes from BENCHMARK.json: those that
list the cell under `workloads`.
"""

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pytorch3dunet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    cell = load_json(root / "workloads" / f"{name}.json")
    return {**cell, "name": name}


def load_config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def load_bench(checkout: Path = CHECKOUT) -> dict:
    path = checkout / "BENCHMARK.json"
    return load_json(path) if path.exists() else {}


def traffic(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  ROOT / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_metrics(bench: dict, cell: str) -> list[dict]:
    return [metric for metric in bench.get("per_layer", []) if cell in metric.get("workloads", ())]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level modules in `modules` (sys.modules), names compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & set(FORBIDDEN_MODULES))


def process_age_s() -> float:
    """Seconds since this process started, from /proc (the host clock since
    the interpreter was exec'd), or since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Window:
    """What a driver's window hands the metric readers and the check."""
    kind: str
    attempted: int
    failed: int
    e2e: dict  # end-to-end metric -> (value, unit)
    patches: int = 0  # network forwards of one patch
    work: dict = field(default_factory=dict)  # roofline.conv_work of one item (volume, update or request)
    spans: dict = field(default_factory=dict)  # host spans the driver took, by name
    trace: object = None


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    compared: dict
    breakdown: dict | None = None

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["compared"] = self.compared
        return json.dumps(out)


def compared_lines(compared: dict) -> list[str]:
    return [f"compared {name} = {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}"
            for name, c in compared.items()]


def trace_notes(trace, top: int = 40) -> list[str]:
    """What a traced run's stderr says of its trace: how many kernels and
    device spans of host ranges it holds, and the kernels with the most
    device time (marked where a conv pattern matches them)."""
    from benchmark.readers import patterns

    pats = patterns()
    lines = [f"trace: {len(trace.in_window(('kernel',)))} kernels, {len(trace.gpu_ranges)} device spans of host ranges"]
    for name, s in sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"trace: {s:.6f} s {'conv' if any(p.search(name) for p in pats) else '    '} {name}")
    return lines


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, root: Path = ROOT,
             bench: dict | None = None, log=print) -> Result:
    """One run of a cell on `device`: set-up, the measured window, the
    per-layer metrics of a traced run, and the check. The caller has made
    sure that the device is there. `root` holds the cell's and the
    configuration's files (the benchmark's own by default); `bench` is
    BENCHMARK.json's content."""
    import torch

    from benchmark.trace import Tracer

    bench = load_bench() if bench is None else bench
    cell = load_cell(cell_name, root)
    config = load_config(cell["config"], root)
    driver = traffic(cell["kind"])
    tracer = Tracer(trace, cell["kind"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    tracer.note("harness")
    state = driver.setup(cell, config, seed, device, tracer)
    sync()
    setup_s = process_age_s()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = driver.window(state, seconds, tracer, sync)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    metrics = {name: {"value": value, "unit": unit} for name, (value, unit) in window.e2e.items()}
    metrics["peak_gib"] = {"value": window_peak / 2**30, "unit": "GiB"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    breakdown = None
    if trace:
        window.trace = tracer.read()
        metrics = {}
        for metric in per_layer_metrics(bench, cell_name):
            value = metric_reader(metric["name"])(window)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        if window.trace is not None:
            dev["busy_s"] = window.trace.busy_s()
            dev["window_s"] = window.trace.window_s
            breakdown = window.trace.breakdown()
            for line in trace_notes(window.trace):
                log(line)

    numbers = driver.check(state, window, cell.get("limits", {}))
    compared = {name: {"value": v, "limit": lim, "ok": bool(v <= lim)} for name, (v, lim) in numbers.items()}
    correct = window.failed == 0 and all(c["ok"] for c in compared.values())
    return Result(correct, window.attempted, window.failed, metrics, dev, compared, breakdown)
