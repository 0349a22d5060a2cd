"""The benchmark of txt2vid_tpu_torch, one run of one cell:

    python -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It needs as many CUDA devices as the cell asks
for and fails without them. It makes its inputs and weights from the seed,
sets up and warms the cell's path, measures for S seconds, checks what the
timed path produced against the plain reference under portbench/reference,
and prints one JSON line last on standard output: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics and the traced
segment's device time. Every number compared is printed beside its limit,
last on standard error and under "checks" in that line. Build and kernel
caches stay under build/ in the checkout.
"""

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "txt2vid_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


_START = process_start()

for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def driver(traffic: dict):
    import importlib
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def layer_metrics(manifest, cell, ctx) -> dict:
    out = {}
    for m in manifest.metrics(cell, "per_layer"):
        value = manifest.reader(m).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(manifest, cell, spec, traffic, result, trace: bool, device) -> dict:
    """The run's JSON result from a driver's output."""
    import torch
    from portbench import correct
    ok, rows = correct.judge(result["checks"], spec.get("limits", {}).get(traffic["driver"], {}))
    if trace:
        ctx = {"layer": result["layer"], "trace": result.get("trace"), "spec": spec,
               "traffic": traffic}
        metrics = layer_metrics(manifest, cell, ctx)
    else:
        # an end-to-end metric split by cells (`train_videos_per_s.f32`) reports
        # the driver's number named before its first dot
        metrics = {m["name"]: {"value": float(result["e2e"][m["name"].split(".")[0]]),
                               "unit": m["unit"]}
                   for m in manifest.metrics(cell, "end_to_end")}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": result.get("peak_bytes") or 0}
    line = {"correct": ok, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev}
    tr = result.get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in rows}
    return line, rows


def execute(manifest, name, seed, seconds, trace, device):
    """Run a cell on `device`; returns (result line, rows of the checks)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.cell(name)
    spec, traffic = manifest.config(cell), manifest.traffic(cell)
    result = driver(traffic).run(spec, traffic, seed, seconds, bool(trace), device,
                                 process_start=_START)
    return result_line(manifest, cell, spec, traffic, result, bool(trace), device)


def main(argv=None) -> int:
    import json
    args = parse(argv)
    from portbench.manifest import Manifest
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    try:
        import torch
        import txt2vid_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: cannot import what it measures: {e}", file=sys.stderr)
        return 2
    # one host thread for torch's own pools: the program's dispatching thread
    # and its loader share the host's cores with nothing else of the harness
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line, rows = execute(manifest, args.workload, args.seed, args.seconds, args.trace, "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, value, limit, where in rows:
        print(f"check {name}: {value!r} (limit {limit!r}; {where})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
