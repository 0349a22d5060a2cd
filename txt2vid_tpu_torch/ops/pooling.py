"""Pooling / resampling primitives on NCHW tensors (counterpart of
txt2vid_tpu/ops/pooling.py, which works channel-last)."""

import torch


def max_pool_2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """(B, C, H, W) max pool k x k stride k, as a reshape + max like the JAX op."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // k, k, w // k, k).amax(dim=(3, 5))


def upsample_nearest_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) nearest-neighbour upsample (torch nn.Upsample default mode)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
