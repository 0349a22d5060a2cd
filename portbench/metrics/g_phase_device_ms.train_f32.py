"""Self device time of the program's `step.g_forward` and `step.g` spans
(the generator's forward, the G update through D; `step.optim` left out)
per traced plain step of the float32 training cells, from CUDA events."""

from portbench.spans import self_device_ms

UNIT, LAYER, MOVES = "ms", "models", "train_videos_per_s.f32"


def read(ctx):
    return self_device_ms(ctx, ("step.g_forward", "step.g"))
