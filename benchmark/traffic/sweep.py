"""Traffic `sweep`: whole volumes predicted back to back, as a lab predicts a
stack of acquisitions, through `DeviceSlidingWindowPredictor.predict_array`
with the normalization statistics that `global_normalization` takes from each
volume (`calculate_stats`, `detect_device_path`), as the predict CLI does.

Cell parameters: `recipe` (the configuration's section to run: model dtype,
predictor, patch, stride, halo, transformer), `volume` (D, H, W), `pool`
(distinct volumes made from the seed, cycled), `cells` (Voronoi cells a
volume), `rate` (the name of the end-to-end rate the cell reports,
`predict_vox_s` when unset). The window runs volumes until `--seconds` have
passed and ends when the last one has come back; its rate is every voxel of
those volumes over all of that time.

The check: the output of one of the window's volumes, drawn from the seed
once the window has closed, against the plain sliding window
(reference/sweep.py) on the same volume and weights; the number compared is
the widest gap of a probability.
"""

import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import roofline, seeded
from benchmark.harness import Window
from benchmark.reference import sweep as ref_sweep


@dataclass
class State:
    recipe: dict
    model_cfg: dict
    params: dict
    model: object
    predictor: object
    volumes: list
    seed: int
    rate: str
    device: object
    outputs: list = None


def recipe_model(config: dict, recipe: dict) -> dict:
    """The model section as the recipe runs it: with its `dtype`, when it names one."""
    model = dict(config["model"])
    if recipe.get("dtype"):
        model["dtype"] = recipe["dtype"]
    return model


def setup(cell, config, seed, device, tracer) -> State:
    from pytorch3dunet_tpu_torch.config import resolve_device
    from pytorch3dunet_tpu_torch.models.unet import get_model
    from pytorch3dunet_tpu_torch.predict import get_predictor

    recipe = config[cell["recipe"]]
    tracer.note("imported")
    device = resolve_device(str(device))
    params = seeded.weights(config["model"], seed, device)
    tracer.note("weights")
    model_cfg = recipe_model(config, recipe)
    model = get_model(model_cfg)
    model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    predictor = get_predictor(model, {"model": model_cfg, "device": device, "predictor": dict(recipe["predictor"]),
                                      "loaders": {}})
    tracer.note("model")
    volumes = seeded.volumes(tuple(cell["volume"]), int(cell["pool"]), seed, device, int(cell.get("cells", 200)))
    tracer.note("volumes")
    state = State(recipe, model_cfg, params, model, predictor, volumes, seed, cell.get("rate", "predict_vox_s"),
                  device)
    predict_one(state, volumes[0], tracer)  # warm-up: the window's one shape
    tracer.note("warm-up")
    return state


def predict_one(state: State, volume: np.ndarray, tracer) -> np.ndarray:
    from pytorch3dunet_tpu_torch.datasets.utils import calculate_stats
    from pytorch3dunet_tpu_torch.inference_device import detect_device_path

    recipe = state.recipe
    with tracer.range("sweep.stats"):
        stats = calculate_stats(volume, skip=not recipe.get("global_normalization", False))
        normalize, stats = detect_device_path(recipe["transformer"], stats)
    with tracer.range("sweep.predict_array"):
        return state.predictor.predict_array(volume, recipe["patch_shape"], recipe["stride_shape"],
                                             recipe["halo_shape"], normalize=normalize, stats=stats)


def window(state: State, seconds: float, tracer, sync) -> Window:
    recipe, volumes = state.recipe, state.volumes
    tracer.hook_model(state.model)
    outputs = []
    tracer.start()
    deadline = time.perf_counter() + seconds
    while True:
        outputs.append(predict_one(state, volumes[len(outputs) % len(volumes)], tracer))
        if time.perf_counter() >= deadline:
            break
    elapsed = tracer.stop(sync)
    state.outputs = outputs
    n = len(outputs)
    shape = volumes[0].shape
    patches = len(ref_sweep.grid(shape, recipe["patch_shape"], recipe["stride_shape"]))
    spatial = [p + 2 * h for p, h in zip(recipe["patch_shape"], recipe["halo_shape"])]
    work = roofline.conv_work(state.model_cfg, spatial, recipe.get("dtype"), count=patches)
    voxels = n * int(np.prod(shape))
    return Window("sweep", n, 0, {state.rate: (voxels / elapsed / 1e6, "Mvox/s")},
                  patches=n * patches, work=work)


def check(state: State, window: Window, limits: dict) -> dict:
    """{'max_abs_gap': (the widest probability gap to the reference, its limit)}."""
    recipe = state.recipe
    index = random.Random(state.seed).randrange(len(state.outputs))
    out = state.outputs[index]
    state.outputs = None
    if not recipe.get("global_normalization"):
        raise ValueError("the plain sweep standardizes with the volume's statistics (global_normalization)")
    state.predictor = state.model = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model_cfg = dict(state.model_cfg, dtype=None)
    blend = recipe["predictor"].get("blend", "assign")
    ref = ref_sweep.predict(state.volumes[index % len(state.volumes)], state.params, model_cfg,
                            recipe["patch_shape"], recipe["stride_shape"], recipe["halo_shape"], blend, state.device)
    gap = ref_sweep.max_gap(out, ref)
    return {"max_abs_gap": (gap, float(limits.get("max_abs_gap", 0.0)))}
