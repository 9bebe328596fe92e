"""The plain model families, one module a family, found by the
configuration's `model.name`: `models/<name>.py` defines

- `features(model_cfg)`: the per-level widths;
- `param_specs(model_cfg)`: (name, shape) of every parameter, in the state
  dict's order (seeded.py draws the weights from it);
- `forward(params, x, model_cfg, quantize=None)`: (probabilities, logits) of
  an (N, C, D, H, W) float32 batch (a 2D family takes D = 1).

A new family is a new file here; nothing else changes.
"""

import importlib


def family(model_cfg: dict):
    return importlib.import_module(f"{__name__}.{model_cfg['name']}")


def features(model_cfg: dict) -> list[int]:
    return family(model_cfg).features(model_cfg)


def param_specs(model_cfg: dict) -> list[tuple[str, tuple]]:
    return family(model_cfg).param_specs(model_cfg)


def forward(params: dict, x, model_cfg: dict, quantize=None):
    return family(model_cfg).forward(params, x, model_cfg, quantize)
