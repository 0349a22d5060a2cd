"""Median device time of the traced gradient-penalty steps of the float32
training cells: the CUDA events of the program's `trainer.step` span with
gp=True, from the device reaching its start to its end (no synchronise of
the harness's own)."""

import statistics

from portbench.spans import segment, steps

UNIT, LAYER, MOVES = "ms", "train step", "train_videos_per_s.f32"


def read(ctx):
    records = segment(ctx)
    if records is None:
        return None
    times = [s.device_ms for s in steps(records, gp=True)]
    if not times or None in times:
        return None
    return statistics.median(times)
