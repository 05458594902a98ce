"""Run one cell several times, one process a run, and report each run's
result and the spread of every metric.

    python3 portbench/sets.py --workload <name> --seeds 11 12 13 \
        [--seconds S] [--trace 0|1] [--out results.jsonl]

The spread of a metric is the distance between its first and third
quartiles (`statistics.quantiles(values, n=4)`) as a share of its
median, taken over the runs after the first (the first in a checkout
builds the kernels).  Each run's standard error goes to <out>.err.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.seconds is None:
        with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
            args.seconds = json.load(f)["run_seconds"]
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        wall = time.perf_counter() - t0
        out = proc.stdout.strip().splitlines()
        try:
            line = json.loads(out[-1]) if out else None
        except json.JSONDecodeError:
            line = None
        rec = {"workload": args.workload, "seed": seed, "rc": proc.returncode,
               "wall_s": wall, "result": line}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            with open(args.out + ".err", "a") as f:
                f.write(f"=== {args.workload} seed {seed} rc "
                        f"{proc.returncode}\n{proc.stderr[-6000:]}\n")
        else:
            sys.stderr.write(proc.stderr[-3000:])
    ok = [r["result"] for r in lines[1:] if r["result"]]
    names = sorted({m for r in ok for m in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in ok
                if name in r["metrics"]]
        print(f"{args.workload} {name}: median {statistics.median(vals)!r} "
              f"spread {spread(vals)!r} over {len(vals)} runs", flush=True)
    correct = sum(bool(r["result"] and r["result"]["correct"])
                  for r in lines)
    print(f"{args.workload}: correct {correct} of {len(lines)}", flush=True)


if __name__ == "__main__":
    main()
