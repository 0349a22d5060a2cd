"""The window's share of the chip's peak in the bfloat16 training cells: the
FLOPs of its steps, counted on the plain reference (portbench/counts.py),
over its seconds and the peak of the configuration's dtype."""

UNIT, LAYER, MOVES = "%", "models", "train_videos_per_s.bf16"


def read(ctx):
    return ctx["layer"].get("mfu")
