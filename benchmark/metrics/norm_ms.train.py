"""norm_ms.train: the device time of the kernels inside the program's norm
spans (`p3d.norm.group`, `p3d.norm.fused`) per update of the traced window, in
ms (spans.py `kernel_ms`). The forward's norms only: GroupNorm's
backward runs on autograd's thread, outside every span. Moves the train
cell's rate, train_vox_s."""

from benchmark.spans import NORM, kernel_ms


def read(window):
    return kernel_ms(window, NORM, window.attempted) if window.kind == "train" else None
