"""idle_share.sweep: the share of the traced window in which the device
ran nothing (readers.py `idle_share`). Moves the gaussian sweep's rate, predict_vox_s."""

from benchmark.readers import idle_share


def read(window):
    return idle_share(window) if window.kind == "sweep" else None
