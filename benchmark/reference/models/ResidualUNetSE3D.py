"""Plain ResidualUNetSE3D (pytorch-3dunet's equations, `unet3d/model.py`
`ResidualUNetSE3D`): ResidualUNet3D (models/ResidualUNet3D.py) with a
concurrent spatial and channel squeeze-and-excitation gate (scSE: Roy et al.,
arXiv:1803.02579, on Hu et al., arXiv:1709.01507; `unet3d/se.py`
`ChannelSpatialSELayer3D`) after every ResNet block, encoders and decoders,
with the reduction ratio 1 that `ResNetBlockSE` hard-codes. On a block's
output x of C channels:

    channel = sigmoid(fc2(relu(fc1(mean_DHW(x)))))   fc1, fc2: C -> C with bias
    spatial = sigmoid(conv_1x1x1(x))                  C -> 1 with bias
    gate(x) = max(x * channel, x * spatial)           element-wise

The mean is over the whole input (the patch), as the published
`AdaptiveAvgPool3d(1)`. No departure from the published equations. The
control's `quantize` rounds the 1x1x1 conv's operands as every conv's; the
two linear layers are no conv and stay float32."""

import torch
import torch.nn.functional as F

from benchmark.reference import blocks
from benchmark.reference.models import ResidualUNet3D

features = ResidualUNet3D.features


def se_specs(prefix: str, c: int) -> list[tuple[str, tuple]]:
    """The parameters of one scSE gate over c channels, in the state dict's order."""
    p = f"{prefix}.se_module"
    return [(f"{p}.cSE.fc1.weight", (c, c)), (f"{p}.cSE.fc1.bias", (c,)), (f"{p}.cSE.fc2.weight", (c, c)),
            (f"{p}.cSE.fc2.bias", (c,)), (f"{p}.sSE.conv.weight", (1, c, 1, 1, 1)), (f"{p}.sSE.conv.bias", (1,))]


def param_specs(model_cfg: dict) -> list[tuple[str, tuple]]:
    """ResidualUNet3D's parameters, each ResNet block's followed by its gate's."""
    specs = []
    for name, shape in ResidualUNet3D.param_specs(model_cfg):
        specs.append((name, shape))
        if name.endswith(".basic_module.conv3.conv.weight"):
            specs += se_specs(name.removesuffix(".conv3.conv.weight"), shape[0])
    return specs


def se_gate(params, prefix, x, quantize):
    p = f"{prefix}.se_module"
    squeezed = x.mean(dim=(2, 3, 4))
    hidden = F.relu(F.linear(squeezed, params[f"{p}.cSE.fc1.weight"], params[f"{p}.cSE.fc1.bias"]))
    channel = torch.sigmoid(F.linear(hidden, params[f"{p}.cSE.fc2.weight"], params[f"{p}.cSE.fc2.bias"]))
    spatial = torch.sigmoid(blocks.conv(x, params[f"{p}.sSE.conv.weight"], params[f"{p}.sSE.conv.bias"],
                                        quantize=quantize))
    return torch.maximum(x * channel[:, :, None, None, None], x * spatial)


def block(params, prefix, x, quantize, groups):
    return se_gate(params, prefix, blocks.resnet_block(params, prefix, x, quantize, groups), quantize)


def forward(params: dict, x: torch.Tensor, model_cfg: dict, quantize=None):
    groups = model_cfg.get("num_groups", 8)
    skips = []
    for i in range(len(features(model_cfg))):
        if i > 0:
            x = F.max_pool3d(x, 2, stride=2)
        x = block(params, f"encoders.{i}.basic_module", x, quantize, groups)
        skips.append(x)
    for i, skip in enumerate(reversed(skips[:-1])):
        p = f"decoders.{i}"
        w = params[f"{p}.upsampling.upsample.conv_transposed.weight"]
        if quantize is not None:
            x, w = quantize(x), quantize(w)
        x = F.conv_transpose3d(x, w, stride=2, padding=1)
        x = skip + F.interpolate(x, size=skip.shape[2:], mode="nearest")
        x = block(params, f"{p}.basic_module", x, quantize, groups)
    return blocks.head(params, x, model_cfg, quantize)
