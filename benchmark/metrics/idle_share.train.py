"""idle_share.train: the share of the traced window in which the device ran
nothing (readers.py `idle_share`)."""

from benchmark.readers import idle_share


def read(window):
    return idle_share(window) if window.kind == "train" else None
