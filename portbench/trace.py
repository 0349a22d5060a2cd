"""Reduce a torch.profiler trace to the benchmark's device numbers.

A traced segment is bracketed by the harness's `portbench.window` range.
From the profiler's events it takes the device's operations (kernels,
copies and sets on the card; not the user ranges the profiler mirrors onto
the device's timeline), merges their intervals and reports the busy time
inside the window, kernel time by name, and the device's idle gaps, each
named by the innermost host operation running at its middle.
"""

import bisect
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
# the serving driver's range around each GeneratorService.generate call
GENERATE = "portbench.generate"


def _events(prof):
    """(name, on_device, is_annotation, start_s, end_s) of every event."""
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation(),
                 e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in raw]
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA,
                 getattr(e, "is_user_annotation", False),
                 e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in prof.events()]


def union(intervals) -> np.ndarray:
    """Merged (start, end) rows of a list of intervals, sorted."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = np.asarray(sorted(intervals), dtype=np.float64)
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the intersection of two merged interval sets."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace:
    def __init__(self, events):
        self.events = events
        windows = [(s, e) for n, dev, _, s, e in events if n == WINDOW and not dev]
        if not windows:
            raise ValueError(f"the trace has no {WINDOW} range")
        self.start, self.end = min(s for s, _ in windows), max(e for _, e in windows)
        self.device = [(n, max(s, self.start), min(e, self.end))
                       for n, dev, ann, s, e in events
                       if dev and not ann and e > self.start and s < self.end]
        self.host = [(n, s, e) for n, dev, ann, s, e in events
                     if not dev and n != WINDOW and e > self.start and s < self.end]
        self.busy = union([(s, e) for _, s, e in self.device])

    @classmethod
    def from_profiler(cls, prof):
        return cls(_events(prof))

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self.busy))

    def ranges(self, name: str) -> np.ndarray:
        """Merged intervals of the host range `name`."""
        return union([(s, e) for n, s, e in self.host if n == name])

    def kernel_s(self, names) -> float:
        """Device seconds of the operations whose names contain one of `names`."""
        return float(sum(e - s for n, s, e in self.device if any(k in n for k in names)))

    def device_ops(self, top: int = 10, width: int = 160):
        """The operations that took most device time, by name (cut to
        `width` characters)."""
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:width]] += e - s
        return [[n, float(t)] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, reach: int = 64):
        """The idle time inside the window by what the host was doing in it:
        each gap named by the innermost host operation running at its
        middle (the latest-starting of the `reach` operations started
        before it that still runs then)."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [s for _, s, _ in host]
        by = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) / 2
            name = "no host operation"
            for j in range(bisect.bisect_right(starts, mid) - 1,
                           max(bisect.bisect_right(starts, mid) - 1 - reach, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] += e - s
        return [[n, float(t)] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def roofline_share(ctx, kernels) -> float | None:
    """The least time of the traced work of `kernels` (the layer's
    `attention_least_s`) over their device time in the trace, in %; None
    when none of them ran."""
    trace, least = ctx.get("trace"), ctx["layer"].get("attention_least_s")
    spent = trace.kernel_s(kernels) if trace is not None else 0.0
    if not spent or least is None:
        return None
    return 100.0 * least / spent
