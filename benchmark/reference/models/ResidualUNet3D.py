"""Plain ResidualUNet3D (pytorch-3dunet's equations): a ResNet block per
level, 2x2x2 max-pools between levels, per decoder a kernel-3 stride-2
transposed conv of the level below (torch padding 1: 2n - 1 voxels from n),
resized nearest to the skip and summed with it, then a ResNet block; the
final 1x1 conv."""

import torch
import torch.nn.functional as F

from benchmark.reference import blocks

DEFAULT_LEVELS = 5


def features(model_cfg: dict) -> list[int]:
    return blocks.features(model_cfg, DEFAULT_LEVELS)


def param_specs(model_cfg: dict) -> list[tuple[str, tuple]]:
    f = features(model_cfg)
    specs = []
    for i, out in enumerate(f):
        prev = model_cfg["in_channels"] if i == 0 else f[i - 1]
        p = f"encoders.{i}.basic_module"
        specs += [(f"{p}.conv1.weight", (out, prev, 1, 1, 1)), (f"{p}.conv1.bias", (out,))]
        specs += blocks.unit_specs(f"{p}.conv2", out, out) + blocks.unit_specs(f"{p}.conv3", out, out)
    rev = f[::-1]
    for i in range(len(rev) - 1):
        specs.append((f"decoders.{i}.upsampling.upsample.conv_transposed.weight", (rev[i], rev[i + 1], 3, 3, 3)))
        p = f"decoders.{i}.basic_module"
        specs += blocks.unit_specs(f"{p}.conv2", rev[i + 1], rev[i + 1])
        specs += blocks.unit_specs(f"{p}.conv3", rev[i + 1], rev[i + 1])
    return specs + blocks.final_specs(model_cfg, f[0])


def forward(params: dict, x: torch.Tensor, model_cfg: dict, quantize=None):
    groups = model_cfg.get("num_groups", 8)
    skips = []
    for i in range(len(features(model_cfg))):
        if i > 0:
            x = F.max_pool3d(x, 2, stride=2)
        x = blocks.resnet_block(params, f"encoders.{i}.basic_module", x, quantize, groups)
        skips.append(x)
    for i, skip in enumerate(reversed(skips[:-1])):
        p = f"decoders.{i}"
        w = params[f"{p}.upsampling.upsample.conv_transposed.weight"]
        if quantize is not None:
            x, w = quantize(x), quantize(w)
        x = F.conv_transpose3d(x, w, stride=2, padding=1)
        x = skip + F.interpolate(x, size=skip.shape[2:], mode="nearest")
        x = blocks.resnet_block(params, f"{p}.basic_module", x, quantize, groups)
    return blocks.head(params, x, model_cfg, quantize)
