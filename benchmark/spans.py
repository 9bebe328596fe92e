"""What the per-layer readers take from the program's own spans: the host
ranges named `p3d.*` that the program opens while a profiler runs (the traced
run's `torch.profiler`; `pytorch3dunet_tpu_torch/utils/misc.py` `span`), and
the device span the profiler gives each. A program that opens none gives the
readers nothing to read: each returns None."""

# GroupNorm modules (`p3d.norm.group`) and the fused decoder's per-branch statistics and affine (`p3d.norm.fused`)
NORM = "p3d.norm."


def kernel_ms(window, prefix: str, per: int) -> float | None:
    """The device time of the kernels inside the device spans of the ranges
    whose name starts with `prefix`, per `per` work items of the traced window
    (its patches, its updates), in ms."""
    if window.trace is None or not per:
        return None
    by_name = window.trace.range_device_s(prefix)
    return None if by_name is None else 1e3 * sum(by_name.values()) / per


def host_ms(window, name: str) -> float | None:
    """The host time of the ranges named `name`, clipped to the traced window,
    per work item it completed (a volume, an update), in ms."""
    if window.trace is None or not window.attempted:
        return None
    lo, hi = window.trace.window
    spans = [(max(r.start, lo), min(r.end, hi)) for r in window.trace.ranges
             if r.name == name and r.end > lo and r.start < hi]
    return 1e3 * sum(b - a for a, b in spans) / window.attempted if spans else None
