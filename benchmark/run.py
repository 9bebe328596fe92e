"""One run of one benchmark cell of the PyTorch/CUDA port on the card(s) of this machine:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the run's
result as one JSON object (see benchmark/README.md); the numbers the check
compared, each beside its limit, are the last lines of standard error. Exits
non-zero with no result when no CUDA device (or fewer than the cell asks for)
is present, when the port cannot be imported from this checkout, or when a
JAX module was loaded by the time the window closed.
"""

import argparse
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    try:
        import pytorch3dunet_tpu_torch
    except ImportError as e:
        print(f"benchmark: the port does not import from {CHECKOUT}: {e}", file=sys.stderr)
        return 2
    if Path(pytorch3dunet_tpu_torch.__file__).resolve().parents[1] != CHECKOUT:
        print(f"benchmark: the port was imported from {pytorch3dunet_tpu_torch.__file__}, outside {CHECKOUT}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.get("chips", 1)):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {cell.get('chips', 1)} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                              log=lambda line: print(line, file=sys.stderr, flush=True))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in harness.compared_lines(result.compared):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
