"""conv_roofline.train: the share of the conv kernels' roofline in the traced
window (readers.py `conv_roofline`). Moves the train cells' rate."""

from benchmark.readers import conv_roofline


def read(window):
    return conv_roofline(window) if window.kind == "train" else None
