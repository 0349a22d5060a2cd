"""Self device time of the program's `step.d` spans (the D updates at every
scale: loss, forward and backward; the optimizer's `step.optim` left out)
per traced plain step of the float32 training cells, from CUDA events."""

from portbench.spans import self_device_ms

UNIT, LAYER, MOVES = "ms", "models", "train_videos_per_s.f32"


def read(ctx):
    return self_device_ms(ctx, ("step.d",))
