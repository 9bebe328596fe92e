"""Shared arithmetic of the per-layer readers: which device kernels carried
the convolutions (the regular expressions in metrics/conv_kernels/*.txt, one
per line; a later kernel under a new name adds a file there), the conv work
the window completed (roofline.py), the idle share, the copies, and the
device time inside the model's host ranges. Each returns None when the run
gives it nothing to read."""

import re
from pathlib import Path

PATTERN_DIR = Path(__file__).resolve().parent / "metrics" / "conv_kernels"


def patterns() -> list[re.Pattern]:
    out = []
    for path in sorted(PATTERN_DIR.glob("*.txt")):
        for line in path.read_text().splitlines():
            if line.strip() and not line.lstrip().startswith("#"):
                out.append(re.compile(line.strip()))
    return out


def conv_kernel_s(trace) -> float:
    """Device seconds of the conv kernels in the traced window."""
    pats = patterns()
    return sum(s for name, s in trace.by_name(("kernel",)).items() if any(p.search(name) for p in pats))


def conv_roofline(window) -> float | None:
    """The least time of the window's conv work over the conv kernels' device time, in %."""
    if window.trace is None or not window.attempted:
        return None
    busy = conv_kernel_s(window.trace)
    return 100.0 * window.attempted * window.work["least_s"] / busy if busy > 0 else None


def mfu(window) -> float | None:
    """The conv operations of the work completed in the traced window, over
    its seconds, over the dtype's peak, in %."""
    if window.trace is None or not window.attempted or window.trace.window_s <= 0:
        return None
    return 100.0 * window.attempted * window.work["flops"] / window.trace.window_s / window.work["peak_flops"]


def idle_share(window) -> float | None:
    """The share of the traced window in which no kernel, copy or memset ran, in %."""
    if window.trace is None or window.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - window.trace.busy_s() / window.trace.window_s)


def transfer_ms(window) -> float | None:
    """The device time of host-to-device and device-to-host copies in the
    traced window, per work item the window completed, in ms."""
    if window.trace is None or not window.attempted:
        return None
    copies = window.trace.by_name(("gpu_memcpy",))
    seconds = sum(s for name, s in copies.items() if "HtoD" in name or "DtoH" in name)
    return 1e3 * seconds / window.attempted if copies else None


def range_ms(window, prefix: str) -> float | None:
    """The device time of the kernels launched inside the host ranges named
    `<prefix><i>` (forward hooks on the model's levels, trace.py), per patch
    forwarded in the traced window, in ms."""
    if window.trace is None or not window.patches:
        return None
    by_level = window.trace.range_device_s(prefix)
    return None if by_level is None else 1e3 * sum(by_level.values()) / window.patches
