"""Host time of the program's `trainer.data` span (the trainer's next() on
its dataset: the loader and the copy to the card) per traced step of the
float32 training cells: the median over the traced steps whose batch's fetch
the segment holds. The median follows the per-batch wait; a loader's restart
at an epoch's end, which a segment of a few steps holds or not by chance,
does not move it."""

import statistics

from portbench.spans import segment

UNIT, LAYER, MOVES = "ms", "trainer and data", "train_videos_per_s.f32"


def read(ctx):
    records = segment(ctx)
    if records is None:
        return None
    waits, fetch = [], None
    for r in records:
        if r.name == "trainer.data":
            fetch = r
        elif r.name == "trainer.step" and fetch is not None:
            waits.append(fetch.host_ms)
            fetch = None
    if not waits or None in waits:
        return None
    return statistics.median(waits)
