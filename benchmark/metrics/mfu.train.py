"""mfu.train: the whole step's share of the card's peak, the conv operations of
the work the traced window completed over its seconds (readers.py `mfu`).
Moves the train cells' rate."""

from benchmark.readers import mfu


def read(window):
    return mfu(window) if window.kind == "train" else None
