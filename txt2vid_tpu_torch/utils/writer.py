"""Scalar metrics writer (counterpart of txt2vid_tpu/utils/writer.py): an
append-only JSONL file, one {"tag", "value", "step", "ts"} object per line.
The JAX package mirrors the scalars to tensorboardX when it is importable;
the port writes the JSONL file only."""

import json
import time
from pathlib import Path

from txt2vid_tpu_torch.utils.misc import ensure_exists


class MetricsWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        ensure_exists(log_dir)
        self.path = Path(log_dir) / filename
        self._f = open(self.path, "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step), "ts": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
