"""Runs of one cell in one process tree, for setting its bounds and limits:

    python benchmark/measure.py --workload <cell> --seconds 20 --seeds 1 2 3 4 5 6 --sets 2 \
        --traced 7 8 9 --extra 10 11 12 --out chiprun_out/bench

First one short run that builds the kernels (its numbers are kept apart; none
with `--first-seconds 0`),
then `--sets` sets of runs of `--seeds` (the same seeds in every set), the
`--traced` seeds with `--trace 1`, and the `--extra` seeds, each run a
process of `benchmark/run.py` in turn. Every run's result line, exit code,
wall time and the end of its standard error go to <out>/<cell>.jsonl; the
summary printed last gives, per end-to-end metric and set, the median and the
spread (the distance between the first and third quartiles of
`statistics.quantiles(values, n=4)`, over the median), and the compared
numbers of every run.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=CHECKOUT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": time.perf_counter() - start,
            "result": result, "stderr": proc.stderr[-6000:]}


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--traced", type=int, nargs="*", default=[])
    parser.add_argument("--extra", type=int, nargs="*", default=[])
    parser.add_argument("--first-seconds", type=float, default=2.0)
    parser.add_argument("--out", default="chiprun_out/bench")
    args = parser.parse_args(argv)

    out_dir = CHECKOUT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    plan = [("first", 2**31 + 101, args.first_seconds, 0)] if args.first_seconds > 0 else []
    plan += [(f"set{k + 1}", s, args.seconds, 0) for k in range(args.sets) for s in args.seeds]
    plan += [("traced", s, args.seconds, 1) for s in args.traced]
    plan += [("extra", s, args.seconds, 0) for s in args.extra]
    runs = []
    with open(out_dir / f"{args.workload}.jsonl", "a") as log:
        for group, seed, seconds, trace in plan:
            record = {"group": group, "card": smi, **run(args.workload, seed, seconds, trace)}
            runs.append(record)
            log.write(json.dumps(record) + "\n")
            log.flush()
            res = record["result"] or {}
            metrics = {k: v["value"] for k, v in res.get("metrics", {}).items()}
            compared = {k: v["value"] for k, v in res.get("compared", {}).items()}
            print(f"{group} seed {seed} trace {trace} rc {record['rc']} wall {record['wall_s']:.1f} s "
                  f"correct {res.get('correct')} attempted {res.get('attempted')} metrics {metrics} "
                  f"compared {compared}", flush=True)
            if record["rc"] != 0:
                print(record["stderr"][-3000:], flush=True)
    for k in range(args.sets):
        group = [r["result"] for r in runs if r["group"] == f"set{k + 1}" and r["result"]]
        for name in sorted({m for r in group for m in r["metrics"]}):
            values = [r["metrics"][name]["value"] for r in group if name in r["metrics"]]
            if len(values) >= 2:
                print(f"summary set{k + 1} {name}: median {statistics.median(values)!r} spread {spread(values)!r} "
                      f"values {values}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
