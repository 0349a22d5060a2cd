"""The share of the time inside GeneratorService.generate, in the traced
segment, in which no kernel, copy or set ran on the card (gaps between
arrivals do not count)."""

from portbench.trace import GENERATE, overlap

UNIT, LAYER, MOVES = "%", "device", "serve_p95_ms"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    ranges = trace.ranges(GENERATE)
    inside = float(sum(e - s for s, e in ranges))
    if not inside:
        return None
    return 100.0 * (1.0 - overlap(trace.busy, ranges) / inside)
