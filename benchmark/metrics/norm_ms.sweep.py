"""norm_ms.sweep: the device time of the kernels inside the program's norm
spans (`p3d.norm.group` around each GroupNorm module, casts included;
`p3d.norm.fused` around the fused decoder's per-branch statistics and affine),
per patch forwarded in the traced window, in ms (spans.py `kernel_ms`).
Leaves out the convs, ReLUs and joins between them. Moves the gaussian
sweep's rate, predict_vox_s."""

from benchmark.spans import NORM, kernel_ms


def read(window):
    return kernel_ms(window, NORM, window.patches) if window.kind == "sweep" else None
