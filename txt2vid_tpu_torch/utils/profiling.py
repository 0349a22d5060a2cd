"""Profiling, spans and device memory (counterpart of txt2vid_tpu/utils/profiling.py).

`trace` records torch.profiler's CPU and CUDA activities for the length of a
block and writes them as a Chrome trace (TensorBoard's
`<host>_<pid>.<ms>.pt.trace.json`) into a directory; `device_memory_stats`
reads each card's allocator counters under the JAX package's names.

`span(name, step=None, always=False, **attrs)` names a phase of the program.
It is on while a torch profiler records or a `recording()` block is open.
Off, it checks that and returns a shared no-op. On, it opens
`torch.profiler.record_function(name)`, so its host range lands in the
profiler's trace on the clock of the kernels it launched, and keeps a `Span`
record: name, the span it opened inside (`parent`), step id (given, else the
parent's), `attrs`, host start and end on the profiler's clock (Unix ns) and,
once CUDA is in use, a pair of CUDA events on the current stream, read by
`spans()` only. A span with `always=True` also adds its host seconds to
`totals()`, on or off. `spans()` returns the records with their device and
self times (one card per process), `clear()` forgets them.

The program's spans, by layer:
- trainer and data (gan/trainer.py): `trainer.data` (always: the dataset's
  next()), `trainer.step` (one per train-step call; step = the iteration),
  `trainer.ema`;
- train step (gan/train_step.py): `step.draw`, `step.encode`,
  `step.g_forward`, `step.d` (each D update; gp=True where it adds the
  gradient penalty), `step.g` (the G update), `step.optim` (the norm, clip
  and optimizer step, inside `step.d` and `step.g`), each with the step id
  of its own step;
- set-up (train/gan.py, ops/_build.py), all always: `setup.models`,
  `setup.data`, `setup.kernels`.
"""

import contextlib
import contextvars
import dataclasses
import time

import torch

# records kept at most; spans past them record nothing
MAX_SPANS = 1 << 16


@dataclasses.dataclass
class Span:
    """One span's record. Host times are Unix ns (the profiler's clock);
    device times are ms from the first recorded span's start event, None
    without CUDA. Self times leave out what the span's children cover."""

    id: int
    name: str
    parent: int | None
    step: int | None
    attrs: dict
    start_ns: int
    end_ns: int | None = None
    device_start_ms: float | None = None
    device_end_ms: float | None = None
    self_ms: float | None = None
    self_device_ms: float | None = None
    events: list | None = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float | None:
        return None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        if self.device_end_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


class _Recorder:
    def __init__(self):
        self.depth = 0              # open recording() blocks
        self.records: list[Span] = []
        self.totals: dict[str, float] = {}  # name -> seconds


_rec = _Recorder()
_open_span = contextvars.ContextVar("txt2vid_tpu_torch open span", default=None)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "step", "always", "attrs", "_t0", "_record", "_token", "_range")

    def __init__(self, name, step, always, attrs):
        self.name, self.step, self.always, self.attrs = name, step, always, attrs
        self._record = None

    def __enter__(self):
        if self.always:
            self._t0 = time.perf_counter()
        if (not (_rec.depth or torch.autograd._profiler_enabled())
                or len(_rec.records) >= MAX_SPANS):
            return self
        # the profiler takes its time inside the range's entry and exit:
        # a record's host times are the middles of those calls
        self._range = torch.profiler.record_function(self.name)
        t = time.time_ns()
        self._range.__enter__()
        t = (t + time.time_ns()) // 2
        parent = _open_span.get()
        step = self.step if self.step is not None else (parent and parent.step)
        rec = Span(len(_rec.records), self.name, parent and parent.id, step, self.attrs, t)
        if torch.cuda.is_initialized():
            rec.events = [torch.cuda.Event(enable_timing=True), None]
            rec.events[0].record()
        _rec.records.append(rec)
        self._token = _open_span.set(rec)
        self._record = rec
        return self

    def __exit__(self, *exc):
        rec = self._record
        if rec is not None:
            if rec.events is not None:
                rec.events[1] = torch.cuda.Event(enable_timing=True)
                rec.events[1].record()
            _open_span.reset(self._token)
            t = time.time_ns()
            self._range.__exit__(*exc)
            rec.end_ns = (t + time.time_ns()) // 2
        if self.always:
            _rec.totals[self.name] = (_rec.totals.get(self.name, 0.0)
                                      + time.perf_counter() - self._t0)
        return False


def span(name: str, step: int | None = None, always: bool = False, **attrs):
    """A context manager naming a phase of the program (see the module's
    docstring); off, the shared no-op."""
    if not (always or _rec.depth or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name, step, always, attrs)


@contextlib.contextmanager
def recording():
    """Spans record inside the block, with no profiler running."""
    _rec.depth += 1
    try:
        yield
    finally:
        _rec.depth -= 1


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _self_time(start, end, children) -> float:
    covered = union((max(s, start), min(e, end)) for s, e in children if e > start and s < end)
    return (end - start) - sum(e - s for s, e in covered)


def spans() -> list[Span]:
    """The records since the last clear(), in start order, each with its
    device times (waiting for its end event) and self times."""
    recs = list(_rec.records)
    timed = [r for r in recs if r.events is not None and r.events[1] is not None]
    if timed:
        ref = timed[0].events[0]
        for r in timed:
            r.events[1].synchronize()
            r.device_start_ms = ref.elapsed_time(r.events[0])
            r.device_end_ms = ref.elapsed_time(r.events[1])
    children = {}
    for r in recs:
        if r.parent is not None:
            children.setdefault(r.parent, []).append(r)
    for r in recs:
        kids = children.get(r.id, ())
        if r.end_ns is not None:
            r.self_ms = _self_time(r.start_ns, r.end_ns, [(k.start_ns, k.end_ns) for k in kids
                                                          if k.end_ns is not None]) / 1e6
        if r.device_ms is not None:
            r.self_device_ms = _self_time(r.device_start_ms, r.device_end_ms,
                                          [(k.device_start_ms, k.device_end_ms) for k in kids
                                           if k.device_ms is not None])
    return recs


def clear():
    """Forget the span records (not the totals)."""
    _rec.records.clear()


def totals() -> dict[str, float]:
    """name -> host seconds of every always span so far."""
    return dict(_rec.totals)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is present) and write its
    Chrome trace into `log_dir`; yields the torch.profiler.profile, whose
    key_averages() the caller may read after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


def device_memory_stats() -> dict:
    """Per card: bytes_in_use and peak_bytes_in_use (the caching allocator's
    allocated bytes, now and at their peak) and bytes_limit (the card's
    memory); empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


def format_memory_stats() -> str:
    parts = []
    for dev, s in device_memory_stats().items():
        peak = (s.get("peak_bytes_in_use") or 0) / 1e9
        used = (s.get("bytes_in_use") or 0) / 1e9
        parts.append(f"{dev}: {used:.2f}GB used, {peak:.2f}GB peak")
    return "; ".join(parts) if parts else "no device memory stats"
