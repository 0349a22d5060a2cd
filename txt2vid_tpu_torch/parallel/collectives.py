"""The collectives of the parallel layer, each counted, over torch.distributed
(NCCL on CUDA, gloo on the CPU).

`all_reduce_sum` and `all_gather_rows` carry autograd: the backward of a sum
over the group is the same sum of the incoming gradients, itself
differentiable, so the gradient penalty's double backward runs through the
global BatchNorm statistics. Every rank must issue the same collectives in
the same order; a rank that holds zero items of a scale still takes part.

`COUNTS[(backend, op)]` counts the calls since the last `reset_counts()`.
"""

from collections import Counter

import torch
import torch.distributed as dist

COUNTS = Counter()


def reset_counts():
    COUNTS.clear()


def _count(op, group):
    COUNTS[dist.get_backend(group), op] += 1


def all_reduce_(t, group):
    """Sum `t` over `group` in place (no autograd); returns `t`."""
    _count("all_reduce", group)
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad.contiguous(), ctx.group), None


def all_reduce_sum(x, group):
    """The sum of `x` over `group`, on every rank, with autograd."""
    return _AllReduceSum.apply(x.contiguous(), group)


def all_gather_cat(x, group, dim: int = 0):
    """The ranks' `x` (one shape on all) concatenated along `dim` in rank
    order (no autograd)."""
    _count("all_gather", group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x, group)

    @staticmethod
    def backward(ctx, grad):
        # this rank's rows of the gradient summed over every rank's use
        total = _AllReduceSum.apply(grad.contiguous(), ctx.group)
        return total.narrow(0, ctx.index * ctx.rows, ctx.rows), None


def all_gather_rows(x, group):
    """The ranks' `x` concatenated along dim 0, with autograd."""
    return _AllGatherRows.apply(x, group)


def rotate(tensors, group, to: int, frm: int):
    """Send `tensors` to global rank `to` and receive their like from global
    rank `frm` (one ring step); returns the received tensors."""
    _count("send_recv", group)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, frm, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def broadcast_(t, group=None, src: int = 0):
    """Rank `src`'s `t` on every rank, in place; returns `t`."""
    _count("broadcast", group)
    dist.broadcast(t, src=src, group=group)
    return t
