"""transfer_ms.sweep: the device time of host-to-device and device-to-host
copies in the traced window, per volume the window completed, in ms
(readers.py `transfer_ms`). Moves the gaussian sweep's rate, predict_vox_s."""

from benchmark.readers import transfer_ms


def read(window):
    return transfer_ms(window) if window.kind == "sweep" else None
