"""BENCHMARK.json against the contract it is written to, and the harness's
discovery: a configuration, a traffic mix, a per-layer metric and a cell
added as new files and entries are found without editing a file."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench.manifest import HERE, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    cells = len(DOC["workloads"])
    assert (2 + 14 * 24) * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert all(w["chips"] == 1 for w in DOC["workloads"]) and cells <= 24


def test_names_and_units():
    for entry in DOC["configs"] + DOC["workloads"] + DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_file_is_there():
    m = Manifest()
    for cell in DOC["workloads"]:
        spec, traffic = m.config(cell), m.traffic(cell)
        assert spec["name"] == cell["config"]
        assert traffic["driver"] in ("train", "serve")
    for metric in DOC["per_layer"]:
        reader = m.reader(metric)
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == (
            metric["unit"], metric["layer"], metric["moves"])
    # readers kept for cells BENCHMARK.json does not list yet load too
    for path in (HERE / "metrics").glob("*.py"):
        reader = m.reader({"name": path.stem})
        assert UNIT.match(reader.UNIT) and NAME.match(reader.MOVES) and callable(reader.read)


def test_per_layer_metrics_move_one_reported_metric():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        reported = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reported
    for w in cells:
        assert any(set(m.get("workloads", cells)) >= {w} and m["name"] != "setup_s"
                   for m in DOC["end_to_end"])
        assert any(w in m["workloads"] for m in DOC["per_layer"])
    layers = {m["layer"] for m in DOC["per_layer"]}
    assert all("\n" not in layer for layer in layers)


def test_configs_name_their_files():
    files = [c["file"] for c in DOC["configs"]]
    assert len(set(files)) == len(files)
    for c in DOC["configs"]:
        assert c["file"].startswith("portbench/")
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["reduced"] == c["reduced"]
        assert all(key in spec for key in c["reduced"])
        assert c["source"].startswith("https://")


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_found_from_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "portbench")
    spec = json.loads((root / "portbench/configs/tganv2_cond64.json").read_text())
    spec["name"] = "tganv2_cond64_b24"
    spec["train"]["batch_size"] = 24
    (root / "portbench/configs/tganv2_cond64_b24.json").write_text(json.dumps(spec))
    (root / "portbench/traffic/burst.json").write_text(json.dumps(
        {"driver": "serve", "why": "bursts", "rate_per_s": 80.0, "sizes": [8], "probs": [1.0],
         "pool_seed": 1, "check_requests": 4, "check_seconds": 2.0, "trace_seconds": 1.0}))
    (root / "portbench/metrics/serve_requests.py").write_text(
        'UNIT, LAYER, MOVES = "requests", "service", "serve_p95_ms"\n\n\n'
        'def read(ctx):\n    return ctx["layer"].get("requests")\n')
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tganv2_cond64_b24", "source": "https://example.org",
                           "file": "portbench/configs/tganv2_cond64_b24.json", "reduced": [],
                           "why": "a smaller batch"})
    doc["workloads"].append({"name": "b24-burst", "config": "tganv2_cond64_b24",
                             "traffic": "burst", "chips": 1, "why": "bursts"})
    doc["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms", "better": "lower",
                              "bound": 0.25, "source": "host_clock", "workloads": ["b24-burst"]})
    doc["per_layer"].append({"name": "serve_requests", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "service", "moves": "serve_p95_ms",
                             "workloads": ["b24-burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    m = Manifest(root)
    cell = m.cell("b24-burst")
    assert m.config(cell)["train"]["batch_size"] == 24
    assert m.traffic(cell)["rate_per_s"] == 80.0
    names = [x["name"] for x in m.metrics(cell, "per_layer")]
    assert names == ["serve_requests"]
    assert m.reader(m.metrics(cell, "per_layer")[0]).read({"layer": {"requests": 3}}) == 3
    assert {x["name"] for x in m.metrics(cell, "end_to_end")} == {
        "serve_p95_ms", "peak_mem_gib", "setup_s"}
    changed = {k for k, v in _digest(root / "portbench").items() if before.get(k) not in (None, v)}
    assert not changed


def test_the_harness_alone_fails(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ the command
    exits non-zero and prints no result."""
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           DOC["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           DOC["workloads"][0]["name"], "--seed", "4", "--seconds", "3"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["correct"]
    assert all(m["value"] > 0 for m in line["metrics"].values())
