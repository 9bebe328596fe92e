"""Plain UNet3D (pytorch-3dunet's equations): per level two `gcr` units (an
encoder's first to max(out // 2, in) channels), 2x2x2 max-pools between
levels, nearest upsampling (F.interpolate's floor(i * in / out)) and channel
concat of the skip and the level below, two `gcr` units per decoder, the
final 1x1 conv."""

import torch
import torch.nn.functional as F

from benchmark.reference import blocks

DEFAULT_LEVELS = 4


def features(model_cfg: dict) -> list[int]:
    return blocks.features(model_cfg, DEFAULT_LEVELS)


def param_specs(model_cfg: dict) -> list[tuple[str, tuple]]:
    f = features(model_cfg)
    specs = []
    for i, out in enumerate(f):
        prev = model_cfg["in_channels"] if i == 0 else f[i - 1]
        mid = max(out // 2, prev)
        p = f"encoders.{i}.basic_module"
        specs += blocks.unit_specs(f"{p}.SingleConv1", prev, mid) + blocks.unit_specs(f"{p}.SingleConv2", mid, out)
    rev = f[::-1]
    for i in range(len(rev) - 1):
        p = f"decoders.{i}.basic_module"
        specs += blocks.unit_specs(f"{p}.SingleConv1", rev[i + 1] + rev[i], rev[i + 1])
        specs += blocks.unit_specs(f"{p}.SingleConv2", rev[i + 1], rev[i + 1])
    return specs + blocks.final_specs(model_cfg, f[0])


def forward(params: dict, x: torch.Tensor, model_cfg: dict, quantize=None):
    groups = model_cfg.get("num_groups", 8)
    skips = []
    for i in range(len(features(model_cfg))):
        if i > 0:
            x = F.max_pool3d(x, 2, stride=2)
        p = f"encoders.{i}.basic_module"
        x = blocks.unit(params, f"{p}.SingleConv1", x, quantize, groups)
        x = blocks.unit(params, f"{p}.SingleConv2", x, quantize, groups)
        skips.append(x)
    for i, skip in enumerate(reversed(skips[:-1])):
        p = f"decoders.{i}.basic_module"
        x = torch.cat([skip, F.interpolate(x, size=skip.shape[2:], mode="nearest")], dim=1)
        x = blocks.unit(params, f"{p}.SingleConv1", x, quantize, groups)
        x = blocks.unit(params, f"{p}.SingleConv2", x, quantize, groups)
    return blocks.head(params, x, model_cfg, quantize)
