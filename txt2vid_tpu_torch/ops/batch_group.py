"""The global batch: the hooks through which the parallel layer
(txt2vid_tpu_torch/parallel) makes the train step's batch-mixing operations
global when the batch is split over data-parallel ranks.

The JAX package states its step once over the global batch and GSPMD
partitions it, so every operation that mixes samples sees all of them. Here
each rank holds its slice, and these operations ask the active group
instead of reading their local tensor:

- BatchNorm's training statistics (models/layers.py): `batch_stats`;
- the losses' batch means (gan/losses.py): `mean` gives this rank's share of
  the global mean, `shared_mean` the global mean itself on every rank (the
  relativistic losses' mean(fake) and mean(real));
- the subsample pyramid's x[::2] of the global batch (ops/subsample.py, the
  generator in models/tganv2.py): `subsample_start`;
- the mismatched captions, a derangement of the global scale-0 batch
  (gan/cond_gan.py): `fake_conds`.

No group is active outside a train step at a data-parallel size above 1, and
then each hook's caller takes its local path, the one it has always taken.
This module imports nothing of the parallel layer.
"""

import contextlib
import contextvars

_GROUP = contextvars.ContextVar("txt2vid_batch_group", default=None)


def group():
    """The active global batch (parallel.mesh.GlobalBatch), or None."""
    return _GROUP.get()


@contextlib.contextmanager
def batch_group(g):
    """Inside the block `g` (None: no group) answers the hooks."""
    token = _GROUP.set(g)
    try:
        yield
    finally:
        _GROUP.reset(token)


def subsample_start(level: int) -> int:
    """The first local item that x[::2] of the global batch keeps at the
    subsample after pyramid level `level` (0 without a group)."""
    g = _GROUP.get()
    return 0 if g is None else g.subsample_start(level)
