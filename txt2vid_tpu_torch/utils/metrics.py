"""Rolling-window metrics (the port's copy of txt2vid_tpu/utils/metrics.py)."""

from collections import deque


class RollingAvg:
    """Windowed running mean over the last `window_size` updates."""

    def __init__(self, window_size: int = 20):
        self.window_size = window_size
        self._values: deque = deque(maxlen=window_size)

    def update(self, value: float) -> None:
        self._values.append(float(value))

    def get(self) -> float:
        if not self._values:
            return 0.0
        return sum(self._values) / len(self._values)

    def __len__(self) -> int:
        return len(self._values)
