"""The control of a cell's check: the plain reference put in the program's
place, computed one precision step below the configuration's dtype
(reference/precision.py), on the inputs and weights a run of that seed makes.
It prints, per seed, the numbers a run's check compares, which the control
has to fail: the upper reading of each limit. The benchmark's own runs never
run it.

    python benchmark/control.py --workload <cell> --seeds 11 12 13

One JSON line per seed on standard output.
"""

import argparse
import json
import random
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell: dict, config: dict, seed: int, device, fault: str | None = None) -> dict:
    """The compared numbers of the control on this seed's inputs; with a
    train `fault` ('half_batch', 'altered_update'), of the reference with
    that fault planted, in float32, in the program's place."""
    import torch

    from benchmark import seeded
    from benchmark.reference import precision
    from benchmark.reference import sweep as ref_sweep
    from benchmark.traffic import train as train_traffic

    recipe = config[cell["recipe"]]
    quantize = precision.below(recipe.get("dtype"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model_cfg = dict(config["model"])
    params = seeded.weights(model_cfg, seed, device)
    if cell["kind"] == "train":
        batches = seeded.batches(tuple(recipe["patch_shape"]), int(cell["pool"]), seed, device,
                                 int(cell.get("cells", 60)))
        state = train_traffic.State(recipe, model_cfg, params, batches, None, device,
                                    int(cell.get("checked_steps", 3)), "")
        reference = train_traffic.reference_steps(state)
        if fault is not None:
            return train_traffic.compare(state, train_traffic.reference_steps(state, fault=fault), reference)
        return train_traffic.compare(state, train_traffic.reference_steps(state, quantize), reference)
    if cell["kind"] == "sweep":
        shape, pool = tuple(cell["volume"]), int(cell["pool"])
        indices = [random.Random(seed).randrange(pool)]  # a run compares one volume drawn from the seed
        blend = recipe["predictor"].get("blend", "assign")
    else:
        shape, pool = tuple(cell["request"]), int(cell["pool"])
        keep = random.Random(seed).sample(range(int(cell["checked_from"])), int(cell["checked"]))
        indices = sorted({i % pool for i in keep + [max(keep) + 1]})  # and the window's last
        blend = "assign"
    volumes = seeded.volumes(shape, pool, seed, device, int(cell["cells"]))
    gap = 0.0
    for i in indices:
        args = (volumes[i], params, model_cfg, recipe["patch_shape"], recipe["stride_shape"], recipe["halo_shape"],
                blend, device)
        gap = max(gap, ref_sweep.max_gap(ref_sweep.predict(*args, quantize=quantize), ref_sweep.predict(*args)))
    return {"max_abs_gap": gap}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", choices=("half_batch", "altered_update"), default=None,
                        help="a train cell: read this fault planted in the float32 reference instead")
    args = parser.parse_args(argv)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    config = harness.load_config(cell["config"])
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "control": readings(cell, config, seed, device, args.fault)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
