"""decoder_ms.grid: the device time of the kernels launched inside the
decoder levels' host ranges (forward hooks on `model.decoders[i]`, trace.py),
per patch forwarded in the traced window, in ms (readers.py `range_ms`).
Moves the grid sweep's rate, predict_vox_s.grid."""

from benchmark.readers import range_ms


def read(window):
    return range_ms(window, "decoder.") if window.kind == "sweep" else None
