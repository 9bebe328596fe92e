"""mfu.sweep: the whole step's share of the card's peak, the conv
operations of the work the traced window completed over its seconds
(readers.py `mfu`). Moves the gaussian sweep's rate, predict_vox_s."""

from benchmark.readers import mfu


def read(window):
    return mfu(window) if window.kind == "sweep" else None
