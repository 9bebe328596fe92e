"""The plain optimizers, one module an optimizer, found by the recipe's
`optimizer.name` (Adam when unset, as the program's default):
`optimizers/<name>.py` defines `make(params, **keys)`, which takes the
optimizer section's other keys and returns an object whose
`step(grads)` updates `params` in place and returns the gradients its state
took. A new optimizer is a new file here; nothing else changes.
"""

import importlib


def optimizer(params: dict, opt_cfg: dict):
    keys = dict(opt_cfg)
    name = keys.pop("name", "Adam")
    return importlib.import_module(f"{__name__}.{name}").make(params, **keys)
