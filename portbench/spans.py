"""What the readers of the program's own spans share.

The program (`txt2vid_tpu_torch.utils.profiling`) records its spans while a
torch profiler runs, in the run's own process: in a traced run, the harness's
segment. `segment` keeps the records inside the trace's window range (the
segment's fetch that ends the dataset closes after it). `calls_per_step`
counts runtime calls of the trace inside the program's `trainer.step` host
ranges. Where the program has no spans (a checkout from before them) or a
run no card, the readers give None.
"""

import bisect
import statistics

# runtime calls that wait for the device, and those that launch a kernel
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")


def profiling():
    """The program's profiling module, or None."""
    try:
        from txt2vid_tpu_torch.utils import profiling as module
    except ImportError:
        return None
    return module


def segment(ctx):
    """The program's span records in the traced window, in start order, or
    None."""
    module = profiling()
    if module is None or not hasattr(module, "spans"):
        return None
    records = module.spans()
    trace = ctx.get("trace")
    if trace is not None:
        lo, hi = trace.start * 1e9, trace.end * 1e9
        records = [r for r in records
                   if r.end_ns is not None and lo <= r.start_ns and r.end_ns <= hi]
    return records or None


def steps(records, gp=None):
    """The `trainer.step` records; with gp True or False, those that do or do
    not hold a `step.d` span tagged gp (a D update with the penalty)."""
    found = [r for r in records if r.name == "trainer.step"]
    if gp is None:
        return found
    return [s for s in found
            if any(d.attrs.get("gp") for d in under(records, s, ("step.d",))) == gp]


def under(records, root, names):
    """The records named one of `names` inside `root`, at any depth."""
    by_id = {r.id: r for r in records}
    out = []
    for r in records:
        if r.name not in names:
            continue
        p = r.parent
        while p is not None and p != root.id:
            p = by_id[p].parent if p in by_id else None
        if p == root.id:
            out.append(r)
    return out


def mean_per_step(values):
    """The mean, None when a value is missing or there is none."""
    if not values or any(v is None for v in values):
        return None
    return statistics.fmean(values)


def sum_of(values):
    """The sum, None when a value is missing."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def self_device_ms(ctx, names):
    """The self device ms of the spans `names` per traced plain step."""
    records = segment(ctx)
    if records is None:
        return None
    return mean_per_step([sum_of(r.self_device_ms for r in under(records, s, names))
                          for s in steps(records, gp=False)])


def calls_per_step(ctx, names):
    """Runtime calls named one of `names` that start inside a `trainer.step`
    host range of the trace, per such range; None without one."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    n_steps = sum(1 for n, _, _ in trace.host if n == "trainer.step")
    if not n_steps:
        return None
    ranges = trace.ranges("trainer.step")
    starts = [s for s, _ in ranges]
    inside = 0
    for n, s, _ in trace.host:
        if n in names:
            i = bisect.bisect_right(starts, s) - 1
            inside += i >= 0 and s <= ranges[i][1]
    return inside / n_steps
