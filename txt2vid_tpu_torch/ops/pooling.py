"""Pooling / resampling primitives on channel-first tensors (counterpart of
txt2vid_tpu/ops/pooling.py, which works channel-last): NCHW for the 2-D ops,
NCDHW for the 3-D ones."""

import torch
import torch.nn.functional as F


def max_pool_2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """(B, C, H, W) max pool k x k stride k, as a reshape + max like the JAX op."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // k, k, w // k, k).amax(dim=(3, 5))


def max_pool_3d(x: torch.Tensor, kt: int = 1, k: int = 2) -> torch.Tensor:
    """(B, C, T, H, W) max pool (kt, k, k) stride (kt, k, k); Attention3d uses
    [1, 2, 2] (pooling.py:43-48)."""
    b, c, t, h, w = x.shape
    return x.reshape(b, c, t // kt, kt, h // k, k, w // k, k).amax(dim=(3, 5, 7))


def avg_pool_3d_shape_aware(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) shape-aware average pool (pooling.py:12-31): each of T, H,
    W is pooled k=2 s=2 only when it is > 1, padded by 1 on both sides when it
    is odd, and the padding's zeros count in the average (count_include_pad)."""
    kernel = [1 if s == 1 else 2 for s in x.shape[2:]]
    if kernel == [1, 1, 1]:
        return x
    pad = [1 if s > 1 and s % 2 else 0 for s in x.shape[2:]]
    return F.avg_pool3d(x, kernel, stride=kernel, padding=pad, count_include_pad=True)


def upsample_nearest_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) nearest-neighbour upsample (torch nn.Upsample default mode)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
