"""A checkout in a temporary directory holding BENCHMARK.json with tiny
cells, the tiny configuration and the benchmark's traffic and metric files,
for runs on the CPU."""

import json
import shutil
from pathlib import Path

from portbench.manifest import HERE, ROOT
from portbench.tests import tiny

TRAFFIC = {
    "tiny_loader": {"driver": "train", "why": "tiny",
                    "trace_min_steps": 2, "trace_seconds": 0.1},
    "tiny_poisson": {"driver": "serve", "why": "tiny", "rate_per_s": 6.0, "sizes": [1, 3],
                     "probs": [0.5, 0.5], "pool_seed": 7, "check_requests": 3,
                     "check_seconds": 2.0, "trace_seconds": 0.5},
}

# the serving metrics' entries, whose readers wait under portbench/metrics
# for a serving cell in BENCHMARK.json
SERVE_P95 = {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
             "source": "host_clock", "workloads": ["tiny-serve"]}
SERVE_LAYERS = [
    {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
     "moves": "serve_p95_ms", "workloads": ["tiny-serve"]}
    for name, unit, better, source, layer in (
        ("serve_service_ms", "ms", "lower", "host_clock", "service"),
        ("serve_mfu", "%", "higher", "host_clock", "models"),
        ("attention_roofline.serve", "%", "higher", "device_trace", "attention kernels K1-K3"),
        ("device_idle_share.serve", "%", "lower", "device_trace", "device"))]


def make_checkout(tmp: Path, limits=None) -> Path:
    """A checkout whose cells run the tiny configuration; `limits` go into
    its configuration file."""
    root = Path(tmp)
    (root / "portbench" / "configs").mkdir(parents=True)
    shutil.copytree(HERE / "metrics", root / "portbench" / "metrics")
    shutil.copytree(HERE / "traffic", root / "portbench" / "traffic")
    for name, traffic in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    spec = tiny.spec()
    spec["limits"] = limits or {}
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(spec))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"] = [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                       "reduced": [], "why": "tiny"}]
    doc["workloads"] = [
        {"name": "tiny-train", "config": "tiny", "traffic": "tiny_loader", "chips": 1,
         "why": "tiny"},
        {"name": "tiny-serve", "config": "tiny", "traffic": "tiny_poisson", "chips": 1,
         "why": "tiny"}]
    for m in doc["end_to_end"] + doc["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-train"]
    doc["end_to_end"].append(SERVE_P95)
    doc["per_layer"] += SERVE_LAYERS
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root
