"""Run one cell several times, each run its own process, and summarise:

    python3 -m portbench.repeat --workload W --seeds 11 12 13 --seconds 40 \\
        [--trace 0|1] [--out chiprun_out/sets/W.jsonl]

Each run is `python3 -m portbench.run ...`; its result line, exit code and
wall time go to --out (one JSON line per run) and the end of its standard
error beside it. The summary gives each metric's median and its spread:
the distance between the first and third quartiles (statistics.quantiles,
n=4) as a share of the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values) if statistics.median(values) else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = Path(args.out or f"chiprun_out/sets/{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", args.workload,
                               "--seed", str(seed), "--seconds", str(args.seconds),
                               "--trace", str(args.trace)], capture_output=True, text=True)
        wall = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if proc.returncode == 0 else None
        except (json.JSONDecodeError, IndexError):
            result = None
        row = {"seed": seed, "rc": proc.returncode, "wall_s": wall, "trace": args.trace,
               "result": result}
        rows.append(row)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        (out.parent / f"{out.stem}.{seed}.{args.trace}.stderr").write_text(proc.stderr[-20000:])
        short = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), "metrics": short,
                          "checks": {k: v["value"] for k, v in
                                     (result or {}).get("checks", {}).items()}}), flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    names = sorted({k for r in rows if r["result"] for k in r["result"]["metrics"]})
    for name in names:
        values = [r["result"]["metrics"][name]["value"] for r in rows
                  if r["result"] and name in r["result"]["metrics"]]
        print(json.dumps({"metric": name, "n": len(values), "median": statistics.median(values),
                          "spread": spread(values), "values": values}), flush=True)


if __name__ == "__main__":
    main()
