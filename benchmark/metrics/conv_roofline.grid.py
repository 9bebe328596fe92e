"""conv_roofline.grid: the share of the conv kernels' roofline in the
traced window (readers.py `conv_roofline`). Moves the grid sweep's rate, predict_vox_s.grid."""

from benchmark.readers import conv_roofline


def read(window):
    return conv_roofline(window) if window.kind == "sweep" else None
