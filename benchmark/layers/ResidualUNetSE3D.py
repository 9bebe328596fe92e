"""The convolutions and the scSE gates of pytorch-3dunet's ResidualUNetSE3D,
from its layer shapes.

`conv_layers`: ResidualUNet3D's (layers/ResidualUNet3D.py). A gate's 1x1x1
spatial conv from C channels to one is not among them: it is part of the gate,
its read of x is in `se_bytes`, and its kernels run inside the gate's `p3d.se`
span, which se_ms.grid reads.

`se_layers(model_cfg, spatial)`: (name, C, voxels) of each gate in the order a
forward calls them, one after every ResNet block: the encoders', then the
decoders' at their skip's level (5 + 4 = 9 at 5 levels).

`se_bytes`: the gates' least bytes in one forward. A gate has to read its
input x once to squeeze it (the channel means must be complete before any
voxel is gated), once more to gate it, and write its output once: 3 * C * V
elements, plus its weights (fc1 and fc2 C x C with bias, the spatial conv C
to 1 with bias) once, all in the compute dtype. The count is of the model's
shapes, so it is the same whatever implements the gate; at the light-sheet
widths the weights are 1.75 MB of a forward's 3.13 GB (bf16).
"""

import numpy as np

from benchmark import roofline
from benchmark.layers.ResidualUNet3D import conv_layers  # noqa: F401 (roofline.py finds it here by the model's name)
from benchmark.layers.UNet3D import level_sizes
from benchmark.reference.models import features


def se_layers(model_cfg: dict, spatial) -> list[tuple[str, int, int]]:
    f = features(model_cfg)
    sizes = level_sizes(spatial, len(f))
    levels = [(f"encoders.{i}", i) for i in range(len(f))] + [(f"decoders.{i}", len(f) - 2 - i)
                                                              for i in range(len(f) - 1)]
    return [(f"{name}.se_module", f[level], int(np.prod(sizes[level]))) for name, level in levels]


def se_bytes(model_cfg: dict, spatial, dtype=None) -> float:
    item = roofline.ITEMSIZE[roofline.dtype_name(dtype)]
    return float(sum(item * (3 * c * v + 2 * (c * c + c) + c + 1) for _, c, v in se_layers(model_cfg, spatial)))
