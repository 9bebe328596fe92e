"""The convolutions of pytorch-3dunet's UNet3D, from its layer shapes: per
level two 3x3x3 convs (an encoder's first to max(out // 2, in) channels),
2x2x2 max-pools between levels (floor), each decoder's two convs at the skip's
size (its first over the concat of the skip and the upsampled level below),
and the final 1x1 conv. Each entry: (name, k, cin, cout, in_spatial,
out_spatial, transposed)."""

from benchmark.reference.models import features


def level_sizes(spatial, levels):
    sizes = [tuple(spatial)]
    for _ in range(levels - 1):
        sizes.append(tuple(s // 2 for s in sizes[-1]))
    return sizes


def conv_layers(model_cfg: dict, spatial) -> list[tuple]:
    f = features(model_cfg)
    sizes = level_sizes(spatial, len(f))
    layers = []
    for i, out in enumerate(f):
        prev = model_cfg["in_channels"] if i == 0 else f[i - 1]
        mid = max(out // 2, prev)
        layers += [(f"encoders.{i}.conv1", 3, prev, mid, sizes[i], sizes[i], False),
                   (f"encoders.{i}.conv2", 3, mid, out, sizes[i], sizes[i], False)]
    for i in range(len(f) - 1):
        level = len(f) - 2 - i
        c = f[level]
        layers += [(f"decoders.{i}.conv1", 3, c + f[level + 1], c, sizes[level], sizes[level], False),
                   (f"decoders.{i}.conv2", 3, c, c, sizes[level], sizes[level], False)]
    layers.append(("final_conv", 1, f[0], model_cfg["out_channels"], sizes[0], sizes[0], False))
    return layers
