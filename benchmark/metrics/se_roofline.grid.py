"""se_roofline.grid: the scSE gates' share of their roofline, in %: the
gates' least time, their least bytes (layers/ResidualUNetSE3D.py `se_bytes`:
one read to squeeze, one to gate and one write of every gate's input, and
the weights) for the patches forwarded at 3.35 TB/s, over the device time of
the kernels inside the `p3d.se` spans (se_ms.grid). Moves the grid sweep's
rate, predict_vox_s.grid.

The window names neither its cell nor the root its files were read from, so
the reader takes, among the cells that the checkout's BENCHMARK.json lists for
this metric, read from the benchmark's own files, the one whose conv work per
volume is the window's (the work is of the model's shapes, dtype and halo'd
patch); None when none is, as in a run of a cell under another root."""

from benchmark import harness, roofline
from benchmark.layers.ResidualUNetSE3D import se_bytes
from benchmark.traffic.sweep import recipe_model

NAME = "se_roofline.grid"


def patch_bytes(window) -> float | None:
    """The gates' least bytes of one patch forward in the window's cell."""
    per_volume = window.patches // window.attempted
    metric = next((m for m in harness.load_bench().get("per_layer", []) if m["name"] == NAME), {})
    for name in metric.get("workloads", []):
        cell = harness.load_cell(name)
        config = harness.load_config(cell["config"])
        recipe = config[cell["recipe"]]
        model_cfg = recipe_model(config, recipe)
        spatial = [p + 2 * h for p, h in zip(recipe["patch_shape"], recipe["halo_shape"])]
        if roofline.conv_work(model_cfg, spatial, recipe.get("dtype"), count=per_volume) == window.work:
            return se_bytes(model_cfg, spatial, recipe.get("dtype"))
    return None


def read(window):
    se_ms = harness.metric_reader("se_ms.grid")(window)
    if not se_ms or not window.attempted:
        return None
    nbytes = patch_bytes(window)
    return None if nbytes is None else 100.0 * nbytes / roofline.HBM_BYTES_PER_S / (se_ms / 1e3)
