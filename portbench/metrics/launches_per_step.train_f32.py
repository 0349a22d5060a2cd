"""Kernel-launch runtime calls inside the program's `trainer.step` host
ranges of the traced segment, per step, in the float32 training cells."""

from portbench.spans import LAUNCHES, calls_per_step

UNIT, LAYER, MOVES = "count", "train step", "train_videos_per_s.f32"


def read(ctx):
    return calls_per_step(ctx, LAUNCHES)
