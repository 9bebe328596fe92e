"""encoder_ms.sweep: the device time of the kernels launched inside the
encoder levels' host ranges (forward hooks on `model.encoders[i]`, trace.py),
per patch forwarded in the traced window, in ms (readers.py `range_ms`).
Moves the gaussian sweep's rate, predict_vox_s."""

from benchmark.readers import range_ms


def read(window):
    return range_ms(window, "encoder.") if window.kind == "sweep" else None
