"""Shared utilities of the port: logging, the class registry, the profiler
spans, small helpers.

The port's own copy of pytorch3dunet_tpu/utils/misc.py (logger,
RunningAverage, number_of_features_per_level, get_class); parity targets in the
reference: pytorch3dunet/unet3d/utils.py:68-112.
"""

import contextlib
import importlib
import logging
import os
import sys

import torch

_LOG_FMT = "%(asctime)s [%(threadName)s] %(levelname)s %(name)s - %(message)s"
_loggers: dict[str, logging.Logger] = {}


def _make_stream_handler() -> logging.Handler:
    # stdout matches the reference's CLI behavior; P3DUNET_LOG_STDERR=1 frees
    # stdout for machine-readable output
    target = sys.stderr if os.environ.get("P3DUNET_LOG_STDERR") else sys.stdout
    handler = logging.StreamHandler(target)
    handler.setFormatter(logging.Formatter(fmt=_LOG_FMT))
    return handler


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    """Cached per-name logger writing timestamped lines to stdout/stderr."""
    if name not in _loggers:
        lg = logging.getLogger(name)
        lg.setLevel(level)
        lg.addHandler(_make_stream_handler())
        _loggers[name] = lg
    return _loggers[name]


class RunningAverage:
    """Streaming mean of scalar updates (reference: unet3d/utils.py:96-107).

    `update(value, n)` folds in `n` observations whose mean is `value`;
    `.avg`, `.sum`, `.count` expose the running statistics.
    """

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n=1):
        self.sum, self.count = self.sum + value * n, self.count + n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host range `name` in the trace of a running `torch.profiler` (the
    benchmark's `--trace 1` run, the trainer's `profile_dir`): a
    `record_function`, so it lands on the profiler's clock beside the kernels
    and gets their device span. With no profiler on the calling thread, or
    while `torch.export` / `torch.compile` trace the caller, a shared null
    context: one C call, where a bare `record_function` costs microseconds
    even with the profiler off. The port's spans are all named `p3d.*`."""
    if torch.autograd._profiler_enabled() and not torch.compiler.is_compiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def number_of_features_per_level(init_channel_number: int, num_levels: int) -> list:
    """Doubling channel schedule per encoder level (unet3d/utils.py:110-112)."""
    schedule, width = [], init_channel_number
    for _ in range(num_levels):
        schedule.append(width)
        width *= 2
    return schedule


def get_class(class_name: str, modules: list[str]) -> type:
    """Resolves a config `name` string to a class, searching `modules` in
    order — the registry-by-importlib pattern the reference uses throughout
    (unet3d/utils.py:331-338), so YAML names resolve identically here."""
    hits = (getattr(importlib.import_module(mod), class_name, None) for mod in modules)
    found = next((cls for cls in hits if cls is not None), None)
    if found is None:
        raise RuntimeError(f"Unsupported class: {class_name}")
    return found
