"""Readings for the limits of `correct`, and the serving cell's rate.

    python3 -m portbench.calibrate readings --workload W --seeds 1 2 ... \\
        [--control tf32|fp8] [--fault half_batch|unchanged|altered]
    python3 -m portbench.calibrate sweep --workload W --rates 20 30 ... --seconds 20

`readings` (at --rates' first rate, where given) runs the cell's checked work for each seed in this one process,
without a measured window (a serving cell serves `check_seconds` of its
traffic), and prints each seed's numbers; with --control also the plain
reference's in that lower precision against the float32 reference, and
with --fault the program's with that fault planted. `sweep` serves the
cell's mix at each fixed rate and prints the share of time the service was
busy and whether the latency grew over the window.
"""

import argparse
import json
import sys
import time

import numpy as np


def readings(args, manifest, cell, spec, traffic, driver):
    from portbench.run import ROOT
    dump = ROOT / "chiprun_out" / "calib"
    dump.mkdir(parents=True, exist_ok=True)
    if args.rates:
        traffic = dict(traffic, rate_per_s=args.rates[0])
    for seed in args.seeds:
        t = time.perf_counter()
        out = driver.run(spec, traffic, seed, 0.0, False, "cuda", fault=args.fault,
                         control=args.control, window=False)
        row = {"workload": cell["name"], "seed": seed, "fault": args.fault,
               "checks": {k: v[0] for k, v in out["checks"].items()},
               "where": {k: v[1] for k, v in out["checks"].items()},
               "seconds": time.perf_counter() - t}
        if args.control:
            row["control"] = args.control
            row["control_checks"] = {k: v[0] for k, v in out["control_checks"].items()}
            row["control_where"] = {k: v[1] for k, v in out["control_checks"].items()}
        print(json.dumps(row), flush=True)
        if "leaves" in out:
            name = f"{cell['name']}.{seed}.{args.fault or args.control or 'program'}.json"
            (dump / name).write_text(json.dumps(out["leaves"]))


def sweep(args, manifest, cell, spec, traffic, driver):
    import torch
    w, _ = driver.make_weights(spec, 1, "cuda")
    svc = driver.build_service(spec, w, "cuda")
    warm = np.random.default_rng(0)
    for n in sorted(set(traffic["sizes"])):
        svc.generate(sentences=driver.data.captions(int(n), warm), seed=0)
    torch.cuda.synchronize()
    for rate in args.rates:
        mix = dict(traffic, rate_per_s=rate)
        due, sizes = driver.schedule(mix, 1, args.seconds)
        client = driver.Client(svc, 1)
        start = time.perf_counter()
        lat, service, _, done = client.serve(due, sizes, start, start + args.seconds)
        q = max(1, len(lat) // 4)
        print(json.dumps({"rate_per_s": rate, "requests": len(lat), "finished": done,
                          "busy_share": 1e-3 * sum(service) / args.seconds,
                          "p50_first_quarter_ms": float(np.median(lat[:q])),
                          "p50_last_quarter_ms": float(np.median(lat[-q:])),
                          "p95_ms": float(np.percentile(lat, 95)),
                          "service_ms_mean": float(np.mean(service))}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("readings", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", default=None)
    p.add_argument("--fault", default=None)
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    import torch
    from portbench.manifest import Manifest
    from portbench.run import ROOT, driver
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    spec, traffic = manifest.config(cell), manifest.traffic(cell)
    {"readings": readings, "sweep": sweep}[args.mode](args, manifest, cell, spec, traffic,
                                                      driver(traffic))
    return 0


if __name__ == "__main__":
    sys.exit(main())
