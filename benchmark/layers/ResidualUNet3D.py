"""The convolutions of pytorch-3dunet's ResidualUNet3D, from its layer
shapes: per encoder level a 1x1 projection to the level's width and two 3x3x3
convs; per decoder a kernel-3 stride-2 transposed conv from the level below
(2n - 1 voxels from n, then resized to the skip) and two 3x3x3 convs at the
skip's size; the final 1x1 conv. Entries as in layers/UNet3D.py."""

from benchmark.layers.UNet3D import level_sizes
from benchmark.reference.models import features


def conv_layers(model_cfg: dict, spatial) -> list[tuple]:
    f = features(model_cfg)
    sizes = level_sizes(spatial, len(f))
    layers = []
    for i, out in enumerate(f):
        prev = model_cfg["in_channels"] if i == 0 else f[i - 1]
        layers += [(f"encoders.{i}.conv1", 1, prev, out, sizes[i], sizes[i], False),
                   (f"encoders.{i}.conv2", 3, out, out, sizes[i], sizes[i], False),
                   (f"encoders.{i}.conv3", 3, out, out, sizes[i], sizes[i], False)]
    for i in range(len(f) - 1):
        level = len(f) - 2 - i
        c, below = f[level], sizes[level + 1]
        layers += [(f"decoders.{i}.deconv", 3, f[level + 1], c, below, tuple(2 * s - 1 for s in below), True),
                   (f"decoders.{i}.conv2", 3, c, c, sizes[level], sizes[level], False),
                   (f"decoders.{i}.conv3", 3, c, c, sizes[level], sizes[level], False)]
    layers.append(("final_conv", 1, f[0], model_cfg["out_channels"], sizes[0], sizes[0], False))
    return layers
