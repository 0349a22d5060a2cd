"""Device time of the program's `step.optim` spans (norm, clip and Adam,
ops/optim.py) and its `trainer.ema` span (gan/ema.py) per traced step of the
float32 training cells, from CUDA events."""

from portbench.spans import mean_per_step, segment, steps, sum_of, under

UNIT, LAYER, MOVES = "ms", "train step", "train_videos_per_s.f32"


def read(ctx):
    records = segment(ctx)
    if records is None:
        return None
    ema = {r.step: r.device_ms for r in records if r.name == "trainer.ema"}
    return mean_per_step([sum_of([*(r.device_ms for r in under(records, s, ("step.optim",))),
                                  ema.get(s.step, 0.0)])
                          for s in steps(records)])
