"""The plain losses, one module a loss, found by the recipe's `loss.name`:
`losses/<name>.py` defines `make(**keys)`, which takes the loss section's
other keys and returns `loss(logits, target)`. The keys every loss takes
are handled here: `skip_last_target` drops the target's last channel first;
`ignore_index` None is the default (a loss that masks takes it itself).

A new loss is a new file here; nothing else changes.
"""

import importlib


def criterion(loss_cfg: dict):
    keys = dict(loss_cfg)
    name = keys.pop("name")
    skip_last = keys.pop("skip_last_target", False)
    if keys.get("ignore_index", 0) is None:
        keys.pop("ignore_index")
    loss = importlib.import_module(f"{__name__}.{name}").make(**keys)
    if not skip_last:
        return loss
    return lambda logits, target: loss(logits, target[:, :-1])
