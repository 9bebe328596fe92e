"""idle_share.grid: the share of the traced window in which the device
ran nothing (readers.py `idle_share`). Moves the grid sweep's rate, predict_vox_s.grid."""

from benchmark.readers import idle_share


def read(window):
    return idle_share(window) if window.kind == "sweep" else None
