"""Utility layer (the port's copies of txt2vid_tpu/utils/*: log, metrics,
stopwatch, misc)."""

from txt2vid_tpu_torch.utils.logging import error, status, warn
from txt2vid_tpu_torch.utils.metrics import RollingAvg
from txt2vid_tpu_torch.utils.misc import count_params, ensure_exists
from txt2vid_tpu_torch.utils.stopwatch import Stopwatch

__all__ = ["status", "warn", "error", "RollingAvg", "Stopwatch", "count_params",
           "ensure_exists"]
