"""The share of the traced segment of the bfloat16 training cells in which
no kernel, copy or set ran on the card: 1 - the union of their intervals
over the segment's length."""

UNIT, LAYER, MOVES = "%", "device", "train_videos_per_s.bf16"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.window_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
