"""Wall-clock stopwatch (the port's copy of txt2vid_tpu/utils/stopwatch.py)."""

import time


class Stopwatch:
    def __init__(self):
        self._start = None
        self.elapsed_time = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self.elapsed_time = time.perf_counter() - self._start
        return self.elapsed_time
