"""norm_ms.grid: the device time of the kernels inside the program's norm
spans (`p3d.norm.group` around each GroupNorm module, its bf16 to f32 casts
included; the grid sweep's ResidualUNet3D fuses no decoder, so no
`p3d.norm.fused`), per patch forwarded in the traced window, in ms
(spans.py `kernel_ms`). Moves the grid sweep's rate, predict_vox_s.grid."""

from benchmark.spans import NORM, kernel_ms


def read(window):
    return kernel_ms(window, NORM, window.patches) if window.kind == "sweep" else None
