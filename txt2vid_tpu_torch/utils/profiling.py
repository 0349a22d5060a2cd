"""Profiling and device memory (counterpart of txt2vid_tpu/utils/profiling.py).

`trace` records torch.profiler's CPU and CUDA activities for the length of a
block and writes them as a Chrome trace (TensorBoard's
`<host>_<pid>.<ms>.pt.trace.json`) into a directory; `step_annotation`
names a step inside it; `device_memory_stats` reads each card's allocator
counters under the JAX package's names.
"""

import contextlib

import torch


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


def step_annotation(name: str, step: int):
    """A range named `name#step` in an active trace (JAX's
    StepTraceAnnotation)."""
    return torch.profiler.record_function(f"{name}#{step}")


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
