"""stats_ms.sweep: the host time of the program's `p3d.stats` span
(`calculate_stats`: the volume's percentiles, mean and std for
`global_normalization`) per volume of the traced window, in ms (spans.py
`host_ms`). Leaves out `detect_device_path` and everything on the device.
Moves the gaussian sweep's rate, predict_vox_s."""

from benchmark.spans import host_ms


def read(window):
    return host_ms(window, "p3d.stats") if window.kind == "sweep" else None
