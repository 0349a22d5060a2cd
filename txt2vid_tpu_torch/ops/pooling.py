"""Pooling / resampling primitives on channel-first tensors (counterpart of
txt2vid_tpu/ops/pooling.py, which works channel-last): NCHW for the 2-D ops,
NCDHW for the 3-D ones."""

import itertools

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


def avg_pool_3d(x: torch.Tensor, kernel, stride, pad=(0, 0, 0)) -> torch.Tensor:
    """(B, C, T, H, W) average pool counting the zero padding, as the JAX
    package's `reduce_window` sum divided by the window size. In float32 and
    float64 that is F.avg_pool3d. In a narrower dtype (bf16) the JAX sum runs
    in x's dtype, each add rounded, where torch accumulates in float32 and
    rounds once: so the value is the window summed one element at a time, in
    the order XLA's CPU backend takes it (measured: (t, h, w), or with
    padding the last padded axis outermost and the others in that order),
    and the gradient the average pool's (the same linear map; in bf16 it is
    not rounded on the way: the windows are 1 or 2 wide, so dividing by
    their size is exact)."""
    if x.dtype in (torch.float32, torch.float64):
        return F.avg_pool3d(x, kernel, stride=stride, padding=pad, count_include_pad=True)
    return _SummedPool.apply(x, tuple(kernel), tuple(stride), tuple(pad))


class _SummedPool(torch.autograd.Function):
    """_window_sum's value, the average pool's gradient. The backward is
    differentiable, so the gradient penalty's double backward goes through."""

    @staticmethod
    def forward(ctx, x, kernel, stride, pad):
        ctx.shape, ctx.args = x.shape, (kernel, stride, pad)
        return _window_sum(x, kernel, stride, pad)

    @staticmethod
    def backward(ctx, g):
        # the CPU backend has no bf16 average pool: its map in float32 there
        dtype = torch.float32 if g.device.type == "cpu" else g.dtype
        gx = torch.ops.aten.avg_pool3d_backward(
            g.to(dtype), g.new_empty(ctx.shape, dtype=dtype), *ctx.args, False, True, None)
        return gx.to(g.dtype), None, None, None


def _window_sum(x, kernel, stride, pad):
    """The average pool's windows summed one element at a time in x's
    dtype, in XLA's order (avg_pool_3d), and divided by the window size."""
    if any(pad):
        x = F.pad(x, (pad[2], pad[2], pad[1], pad[1], pad[0], pad[0]))
    out = [(size - k) // s + 1 for size, k, s in zip(x.shape[2:], kernel, stride)]
    padded = [a for a in range(3) if pad[a]]
    axes = padded[-1:] + [a for a in range(3) if a not in padded[-1:]]
    total = None
    for offsets in itertools.product(*(range(kernel[a]) for a in axes)):
        start = [0, 0, 0]
        for a, o in zip(axes, offsets):
            start[a] = o
        tap = x[:, :, *(slice(o, o + s * (n - 1) + 1, s)
                        for o, s, n in zip(start, stride, out))]
        total = tap if total is None else total + tap
    return total / (kernel[0] * kernel[1] * kernel[2])


def avg_pool_3d_shape_aware(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) shape-aware average pool (pooling.py:12-31): each of T, H,
    W is pooled k=2 s=2 only when it is > 1, padded by 1 on both sides when it
    is odd, and the padding's zeros count in the average (count_include_pad)."""
    kernel = [1 if s == 1 else 2 for s in x.shape[2:]]
    if kernel == [1, 1, 1]:
        return x
    pad = [1 if s > 1 and s % 2 else 0 for s in x.shape[2:]]
    return avg_pool_3d(x, kernel, kernel, pad)


def upsample_nearest_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, C, H, W) nearest-neighbour upsample (torch nn.Upsample default mode)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)
