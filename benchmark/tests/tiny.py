"""Tiny copies of the benchmark's configurations and cells, for runs of the
harness on the CPU: the same files, with small widths, depths and volumes."""

import json
from pathlib import Path

from benchmark.harness import ROOT

SMALL_MODEL = {"f_maps": 4, "num_levels": 3, "num_groups": 2}
SMALL_CELLS = {
    "confocal_unet3d.sweep_gaussian": {"volume": [16, 24, 48], "pool": 2, "cells": 6},
    "confocal_unet3d.train_bf16": {"pool": 4, "cells": 6},
    "confocal_unet3d.serve": {"request": [8, 24, 24], "pool": 3, "cells": 6, "checked": 2, "checked_from": 3},
    "lightsheet_resunet3d.sweep_grid_bf16": {"volume": [16, 24, 48], "pool": 2, "cells": 6},
}
PATCH, HALO, STRIDE = [8, 24, 24], [2, 4, 4], [4, 12, 12]


def write_tiny(root: Path) -> Path:
    """Writes configs/ and workloads/ of the tiny cells under `root`, each
    cell with its TINY_LIMITS."""
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(parents=True, exist_ok=True)
    for path in (ROOT / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["model"].update(SMALL_MODEL)
        for recipe in ("predict", "serve"):
            if recipe in config:
                section = config[recipe]
                overlapping = section["stride_shape"] != section["patch_shape"]
                section.update(patch_shape=PATCH, halo_shape=HALO, stride_shape=STRIDE if overlapping else PATCH)
        if "serve" in config:
            # on the CPU the server's predictor has to be named: only CUDA turns the host loop into the sweep
            config["serve"]["predictor"] = {"name": "DeviceSlidingWindowPredictor"}
        if "train" in config:
            # float32: at these widths a bf16 step's gradients are noise-sized for some parameters; the bf16
            # cell's readings are taken on the card at its own size
            config["train"].update(patch_shape=[8, 32, 32], dtype=None)
        (root / "configs" / path.name).write_text(json.dumps(config))
    for name, small in SMALL_CELLS.items():
        cell = json.loads((ROOT / "workloads" / f"{name}.json").read_text())
        cell.update(small, limits=TINY_LIMITS[name])
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return root

# limits of the tiny cells on the CPU, between what the program reads there
# and what the control does (test_bench_control.py)
TINY_LIMITS = {
    "confocal_unet3d.sweep_gaussian": {"max_abs_gap": 1e-4},
    "lightsheet_resunet3d.sweep_grid_bf16": {"max_abs_gap": 0.03},
    "confocal_unet3d.serve": {"max_abs_gap": 1e-4},
    "confocal_unet3d.train_bf16": {"logit_gap": 1e-4, "grad_gap": 1e-3, "first_loss_gap": 1e-4, "change_gap": 1e-3},
}
