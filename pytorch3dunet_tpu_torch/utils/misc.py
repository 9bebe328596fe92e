"""Shared utilities of the port: logging, the class registry, small helpers.

The port's own copy of pytorch3dunet_tpu/utils/misc.py (logger,
RunningAverage, number_of_features_per_level, get_class); parity targets in the
reference: pytorch3dunet/unet3d/utils.py:68-112.
"""

import importlib
import logging
import os
import sys

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


# The ROADMAP.md Queue 1 items that the port's refusals name, by title: a
# re-anchor renumbers the queue but keeps the titles
# (tests/test_torch_port_host.py holds each to a live item of ROADMAP.md).
ITEM_LOSSES = "The rest of the losses and metrics"
ITEM_PREDICTORS = "Predictor breadth"
ITEM_2D = "The 2D families and the remaining model options"
ITEM_TRAINER = "Trainer breadth"
ITEM_PARALLELISM = "Parallelism"


def roadmap(item: str) -> str:
    """The reference to a ROADMAP Queue 1 item that a refusal names."""
    return f'ROADMAP Queue 1, "{item}"'


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a class or option of the JAX package that the port does
    not run yet, naming the ROADMAP item that ports it."""
    return NotImplementedError(f"{what} is not ported to PyTorch yet ({roadmap(item)})")
