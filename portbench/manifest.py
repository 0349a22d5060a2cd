"""The benchmark's manifest and the files it names.

`BENCHMARK.json` at the root of the checkout lists the configurations, cells
and metrics. Each is found by name: a configuration in its `file`, a traffic
mix in `portbench/traffic/<traffic>.json`, a per-layer metric's reader in
`portbench/metrics/<name>.py`. Adding a cell, a mix, a configuration or a
metric adds files and entries; no file here changes.
"""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(there are {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        return json.loads((self.root / self.configs[cell["config"]]["file"]).read_text())

    def traffic(self, cell: dict) -> dict:
        return json.loads((self.root / "portbench" / "traffic"
                           / f"{cell['traffic']}.json").read_text())

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The cell's end_to_end or per_layer entries: those whose
        `workloads` list it, or that have none."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: dict):
        """The module of a per-layer metric's reader."""
        path = self.root / "portbench" / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric['name']}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
