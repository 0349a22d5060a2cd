"""TGANv2 subsampling pyramid (counterpart of txt2vid_tpu/ops/subsample.py).

Videos are (B, T, ...) with batch and time leading, so these ops serve both the
JAX layout (B, T, H, W, C) at the public boundaries and the generator's
(B, T, C, H, W) inside. The random temporal phase `bt` is an argument: the
caller draws it (or replays the JAX package's draw in a parity test).
"""

import torch
import torch.nn.functional as F


def subsample_video(x: torch.Tensor, bt: int, sn: int = 2, st: int = 2) -> torch.Tensor:
    """(B, T, ...) -> (ceil(B/sn), T/st, ...): every sn-th batch element and the
    frames bt, bt+st, ... (subsample.py:14-26). Requires st | T, 0 <= bt < st."""
    t = x.shape[1]
    if t % st:
        raise ValueError(f"frame count {t} not divisible by st={st}")
    if not 0 <= bt < st:
        raise ValueError(f"phase {bt} outside [0, {st})")
    return x[::sn, bt::st]


def subsample_batch_half(c: torch.Tensor, sn: int = 2) -> torch.Tensor:
    """Batch-only decimation, keeping cond vectors aligned with a subsampled
    batch."""
    return c[::sn]


def resize_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, size, size, C), sampling source pixel
    floor((i + 0.5) * H / size) as jax.image.resize(..., "nearest") does: that
    is torch's "nearest-exact", not its "nearest"."""
    b, t, h, w, c = x.shape
    frames = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)       # a channels-last view
    out = F.interpolate(frames, size=(size, size), mode="nearest-exact")
    return out.permute(0, 2, 3, 1).reshape(b, t, size, size, c)


def multiscale_pyramid(x: torch.Tensor, cond, frame_sizes, phases, subsample_input: bool):
    """The real-data pyramid matched to the generator's scales (subsample.py:54-87).

    x: (B, T, H, W, C) at frame_sizes[-1]; cond (B, D) or None; phases: the
    len(frame_sizes) - 1 temporal phases when subsample_input. Scale i is x
    resized to frame_sizes[i]; with subsample_input, x (and cond's batch) are
    subsampled after each scale is emitted. Returns (xs, conds), smallest scale
    first; conds is None when cond is None."""
    n = len(frame_sizes)
    if n == 1:
        return [x], (None if cond is None else [cond])
    if subsample_input and len(phases) != n - 1:
        raise ValueError(f"{n} frame sizes need {n - 1} phases, got {len(phases)}")
    xs, conds = [], []
    for i, fs in enumerate(frame_sizes):
        xs.append(x if i == n - 1 else resize_nearest(x, fs))
        if cond is not None:
            conds.append(cond)
        if subsample_input and i != n - 1:
            x = subsample_video(x, phases[i])
            if cond is not None:
                cond = subsample_batch_half(cond)
    return xs, (conds if cond is not None else None)
