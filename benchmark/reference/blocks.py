"""Plain float32 building blocks of the model families in models/, as
functions of a dict of parameters named as the reference's state dict.

- A `gc(r)` conv unit: GroupNorm over the conv's input channels in
  `num_groups` groups (one group below that many channels, eps 1e-5), a
  3x3x3 pad-1 conv without bias, ReLU.
- A ResNet block: a 1x1 projection with bias when the channel count changes,
  a `gcr` then a `gc` unit, the residual sum, ReLU.

`quantize`, when given, rounds each conv's input and weight before the conv:
the control's lower precision (precision.py).
"""

import torch.nn.functional as F

EPS = 1e-5


def features(model_cfg: dict, default_levels: int) -> list[int]:
    """The per-level widths: `f_maps` doubled over `num_levels` (the family's
    `default_levels` when unset), or the list as given."""
    f_maps = model_cfg["f_maps"]
    if isinstance(f_maps, int):
        levels = model_cfg.get("num_levels") or default_levels
        return [f_maps * 2**i for i in range(levels)]
    return list(f_maps)


def unit_specs(prefix: str, cin: int, cout: int, k: int = 3) -> list[tuple[str, tuple]]:
    """The parameters of one `gc(r)` conv unit: the norm over cin, the conv."""
    return [(f"{prefix}.groupnorm.weight", (cin,)), (f"{prefix}.groupnorm.bias", (cin,)),
            (f"{prefix}.conv.weight", (cout, cin, k, k, k))]


def final_specs(model_cfg: dict, f0: int) -> list[tuple[str, tuple]]:
    return [("final_conv.weight", (model_cfg["out_channels"], f0, 1, 1, 1)),
            ("final_conv.bias", (model_cfg["out_channels"],))]


def conv(x, w, b=None, padding=0, quantize=None):
    if quantize is not None:
        x, w = quantize(x), quantize(w)
    return F.conv3d(x, w, b, padding=padding)


def unit(params, prefix, x, quantize, groups, relu=True):
    cin = x.shape[1]
    x = F.group_norm(x, 1 if cin < groups else groups, params[f"{prefix}.groupnorm.weight"],
                     params[f"{prefix}.groupnorm.bias"], EPS)
    x = conv(x, params[f"{prefix}.conv.weight"], padding=1, quantize=quantize)
    return F.relu(x) if relu else x


def resnet_block(params, prefix, x, quantize, groups):
    if f"{prefix}.conv1.weight" in params:
        x = conv(x, params[f"{prefix}.conv1.weight"], params[f"{prefix}.conv1.bias"], quantize=quantize)
    y = unit(params, f"{prefix}.conv2", x, quantize, groups)
    y = unit(params, f"{prefix}.conv3", y, quantize, groups, relu=False)
    return F.relu(y + x)


def head(params, x, model_cfg, quantize):
    """(probabilities, logits): the final 1x1 conv with bias, then a sigmoid or a softmax over channels."""
    logits = conv(x, params["final_conv.weight"], params["final_conv.bias"], quantize=quantize)
    probs = logits.sigmoid() if model_cfg.get("final_sigmoid", True) else logits.softmax(dim=1)
    return probs, logits
