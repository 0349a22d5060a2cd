"""TGANv2 subsampling pyramid (counterpart of txt2vid_tpu/ops/subsample.py).

Videos are (B, T, ...) with batch and time leading, so these ops serve both the
JAX layout (B, T, H, W, C) at the public boundaries and the generator's
(B, T, C, H, W) inside. The random temporal phase `bt` is an argument: the
caller draws it (or replays the JAX package's draw in a parity test), and so
are subsample_rect's crop offsets, or they are drawn from the caller's
torch.Generator.
"""

import torch
import torch.nn.functional as F

from txt2vid_tpu_torch.ops.batch_group import subsample_start


def subsample_video(x: torch.Tensor, bt: int, sn: int = 2, st: int = 2,
                    start: int = 0) -> torch.Tensor:
    """(B, T, ...) -> (ceil(B/sn), T/st, ...): every sn-th batch element from
    `start` and the frames bt, bt+st, ... (subsample.py:14-26). Requires
    st | T, 0 <= bt < st. A rank holding a slice of a global batch passes the
    first local item whose global index is even (ops.batch_group)."""
    t = x.shape[1]
    if t % st:
        raise ValueError(f"frame count {t} not divisible by st={st}")
    if not 0 <= bt < st:
        raise ValueError(f"phase {bt} outside [0, {st})")
    return x[start::sn, bt::st]


def subsample_batch_half(c: torch.Tensor, sn: int = 2, start: int = 0) -> torch.Tensor:
    """Batch-only decimation, keeping cond vectors aligned with a subsampled
    batch."""
    return c[start::sn]


def subsample_rect(x: torch.Tensor, width: int, height: int, depth: int | None = None,
                   offsets=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """A spatial crop of (B, H, W, C) to (B, height, width, C), or a
    spatio-temporal one of (B, T, H, W, C) to (B, depth, height, width, C)
    (depth None keeps all T frames) (subsample.py:35-51). `offsets` are the
    crop's start, (py, px) or (pz, py, px); without them each is drawn
    uniformly from its valid range with `generator`, in the order z, y, x.
    Returns a view of x."""
    if x.dim() == 4:
        sizes, axes = (height, width), (1, 2)
    elif x.dim() == 5:
        sizes, axes = (x.shape[1] if depth is None else depth, height, width), (1, 2, 3)
    else:
        raise ValueError(f"subsample_rect takes a 4-D or 5-D tensor, not {x.dim()}-D")
    limits = [x.shape[a] - s for a, s in zip(axes, sizes)]
    if any(lim < 0 for lim in limits):
        raise ValueError(f"crop {sizes} larger than {tuple(x.shape[a] for a in axes)}")
    if offsets is None:
        offsets = [int(torch.randint(0, lim + 1, (), generator=generator)) for lim in limits]
    if len(offsets) != len(sizes) or not all(0 <= o <= lim for o, lim in zip(offsets, limits)):
        raise ValueError(f"offsets {tuple(offsets)} outside [0, {tuple(limits)}]")
    for a, o, s in zip(axes, offsets, sizes):
        x = x.narrow(a, int(o), s)
    return x


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
            start = subsample_start(i)
            x = subsample_video(x, phases[i], start=start)
            if cond is not None:
                cond = subsample_batch_half(cond, start=start)
    return xs, (conds if cond is not None else None)
