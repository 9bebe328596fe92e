"""se_ms.grid: the device time of the kernels inside the program's scSE gate
spans (`p3d.se` around each `ChannelSpatialSELayer3D` forward: the squeeze,
the two linear layers, the spatial 1x1x1 conv, the sigmoids, the products and
their maximum), per patch forwarded in the traced window, in ms (spans.py
`kernel_ms`). The profiler gives each kernel to the innermost range, so these
kernels are no longer in `encoder_ms.grid` / `decoder_ms.grid`. Moves the grid
sweep's rate, predict_vox_s.grid."""

from benchmark.spans import kernel_ms

SE = "p3d.se"


def read(window):
    return kernel_ms(window, SE, window.patches) if window.kind == "sweep" else None
