"""The mesh of process groups and the step's global semantics across ranks
(counterpart of txt2vid_tpu/parallel/mesh.py).

The JAX package runs one process that sees every device: it states its
train step once over the global batch, and GSPMD partitions it over a
(dp, sp, fsdp) mesh (mesh.py:34-53). Here one process drives one card, and
`Mesh` gives each rank its place: world size = dp * sp * fsdp, ranks laid
out as np.arange(world).reshape(dp, sp, fsdp), make_mesh's order, one
process group per axis through each rank. The step's result is that of one
device on the global batch:

- dp: the global batch is split over the dp ranks, rank r holding items
  [r * B/dp, (r + 1) * B/dp); the draws are global and each rank keeps its
  rows (`GlobalBatch.localize`). Every operation that mixes samples is made
  global through ops/batch_group.py (`GlobalBatch`): BatchNorm's statistics,
  the losses' means (each rank's loss is its partial sum over the global
  count), the subsample pyramid's x[::2] of the global batch and the
  derangement of the global captions. The gradients are summed over dp
  before the norm and the clip, so the optimizers stay identical on every
  rank; the logged losses are summed without a gradient, so every rank sees
  the same values.
- sp: everything outside the non-local attention is replicated over the sp
  ranks of a dp group; attention runs as ring attention over them
  (ops/ring_attention.py) under ops.attention.sequence_parallel.
- fsdp: ZeRO-3 state at rest (`ShardedState`): parameters, BatchNorm
  statistics and the optimizers' moments are stored as each rank's shard by
  `fsdp_spec` (mesh.py:98-112); a step gathers the full parameters, computes
  on the batch (replicated over fsdp), and each rank updates only its shard
  of each sharded leaf. Checkpoints gather the full state.

With a mesh of world size 1 (the training CLI under a process group on one
card) each of these is the local computation, and only the gradient and
metric sums run, as collectives of one rank.
"""

import contextlib
import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from txt2vid_tpu_torch.ops import batch_group
from txt2vid_tpu_torch.ops.attention import sequence_parallel
from txt2vid_tpu_torch.ops.ring_attention import SpGroup
from txt2vid_tpu_torch.parallel.collectives import (all_gather_cat, all_gather_rows, all_reduce_,
                                                    all_reduce_sum)

# the optimizer state entries shaped like their parameter: Adam's moments
# (torch.optim.Adam and ops.optim.AdamStorage) and SGD's trace
MOMENT_KEYS = ("exp_avg", "exp_avg_sq", "momentum_buffer")


def fsdp_spec(shape, fsdp_size: int, min_shard_elems: int = 1024):
    """The dimension a leaf of `shape` is split along over fsdp, or None for
    a replicated leaf (_fsdp_spec, mesh.py:98-112): the largest dimension
    that fsdp_size divides; leaves under min_shard_elems * fsdp_size
    elements and indivisible ones stay replicated."""
    size = int(np.prod(shape)) if len(shape) else 1
    if len(shape) == 0 or size < min_shard_elems * fsdp_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if shape[i] % fsdp_size == 0:
            return i
    return None


def dp_slice(batch: dict, dp_index: int, dp: int) -> dict:
    """Rank dp_index's rows of a global host batch (every array's dim 0)."""
    n = len(next(iter(batch.values())))
    if n % dp:
        raise ValueError(f"batch of {n} does not split over dp={dp}")
    k = n // dp
    return {key: v[dp_index * k:(dp_index + 1) * k] for key, v in batch.items()}


class GlobalBatch:
    """This rank's slice of a global batch split over the dp group, and the
    hooks of ops/batch_group.py. Level 0 is the batch as fed, rows
    [dp_index * local, (dp_index + 1) * local); level i + 1 keeps the items of
    level i whose global index is even (x[::2], renumbered), so a rank keeps
    ceil((offset + count) / 2) - ceil(offset / 2) of them, zero included.
    `subsampled` False (no subsample pyramid) keeps every scale at level 0."""

    def __init__(self, group, dp_index: int, dp: int, local: int, subsampled: bool = True):
        self.group = group
        self.subsampled = subsampled
        self._layouts = [(dp_index * local, local)]

    def layout(self, level: int):
        """(offset, count) of this rank's items at `level` of the global batch."""
        while len(self._layouts) <= level:
            off, n = self._layouts[-1]
            start = (off + 1) // 2
            self._layouts.append((start, (off + n + 1) // 2 - start))
        return self._layouts[level]

    def scale_rows(self, t, scale: int):
        """This rank's rows of a global per-scale tensor (dim 0)."""
        off, n = self.layout(scale if self.subsampled else 0)
        return t[off:off + n]

    def subsample_start(self, level: int) -> int:
        return self.layout(level)[0] % 2

    def localize(self, draws):
        """A step's global draws with z and the GP weights cut to this rank's
        rows; the derangements stay global (fake_conds reads them)."""
        def rows(alphas):
            return None if alphas is None else [[self.scale_rows(a, s) for s, a in enumerate(per_d)]
                                                for per_d in alphas]
        off, n = self.layout(0)
        return dataclasses.replace(
            draws, z=draws.z[off:off + n], alphas=rows(draws.alphas),
            later_d_steps=[(perms, rows(alphas)) for perms, alphas in draws.later_d_steps])

    def batch_stats(self, x32, dims):
        """BatchNorm's (mean, biased variance) over the global batch, with
        autograd: one sum of (sum, sum of squares, count) over the group."""
        c = x32.shape[1]
        count = x32.new_full((1,), float(x32.numel() // c))
        total = all_reduce_sum(torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]),
                               self.group)
        mean = total[:c] / total[-1]
        return mean, torch.clamp(total[c:2 * c] / total[-1] - mean * mean, min=0.0)

    def _count(self, x):
        return all_reduce_(torch.full((), float(x.numel()), device=x.device), self.group)

    def mean(self, x):
        """This rank's share of the global mean: its sum over the global count."""
        return x.sum() / self._count(x)

    def shared_mean(self, x):
        """The global mean on every rank, its gradient reaching every rank."""
        return all_reduce_sum(x.sum(), self.group) / self._count(x)

    def fake_conds(self, cond_scales, perm):
        """Scale i's mismatched conds: rows of the global scale-0 cond
        permuted by `perm` (global), truncated to scale i's global batch, at
        this rank's positions of scale i."""
        full = all_gather_rows(cond_scales[0], self.group)
        fake0 = full[perm.to(full.device)]
        return [self.scale_rows(fake0, i) for i in range(len(cond_scales))]


class ShardedState:
    """ZeRO-3 over the fsdp group for a TrainStep: the modules' parameters and
    buffers, the optimizers' moments and the generator's EMA are kept as this
    rank's shard (fsdp_spec's dimension, chunk fsdp_index) of every leaf
    fsdp_spec splits; the others stay whole. Shards the state on creation."""

    def __init__(self, mesh, step, ema=None):
        self.mesh, self.step, self.ema = mesh, step, ema
        gan = step.gan
        modules = [m for m in (gan.gen, *gan.discrims, gan.cond_encoder, gan.sample_mapping)
                   if m is not None]
        self.dims, seen = {}, set()
        self.tensors = []
        for t in itertools.chain.from_iterable(
                itertools.chain(m.parameters(), m.buffers()) for m in modules):
            if id(t) in seen:
                continue
            seen.add(id(t))
            dim = fsdp_spec(tuple(t.shape), mesh.fsdp)
            if dim is not None:
                self.tensors.append((t, dim))
                self.dims[id(t)] = dim
        self.ema_dims = {n: self.dims[id(p)] for n, p in gan.gen.named_parameters()
                         if id(p) in self.dims}
        self._shard_rest()

    def _local(self, t, dim):
        return t.chunk(self.mesh.fsdp, dim)[self.mesh.fsdp_index].clone()

    def _full(self, t, dim):
        return all_gather_cat(t, self.mesh.fsdp_group, dim)

    def _moments(self):
        """(state dict, key, parameter) of every sharded parameter's moment."""
        for opt in (self.step.opt_g, self.step.opt_d):
            for p, st in opt.state.items():
                if id(p) in self.dims:
                    for key in MOMENT_KEYS:
                        if st.get(key) is not None:
                            yield st, key, p

    def _map_rest(self, fn):
        for st, key, p in self._moments():
            st[key] = fn(st[key], self.dims[id(p)])
        if self.ema is not None:
            for n, dim in self.ema_dims.items():
                self.ema[n] = fn(self.ema[n], dim)

    def _shard_rest(self):
        self._map_rest(self._local)
        for t, dim in self.tensors:
            t.data = self._local(t.data, dim)

    @contextlib.contextmanager
    def gathered(self):
        """The full parameters and buffers inside the block (a train step);
        this rank's shards of them after."""
        for t, dim in self.tensors:
            t.data = self._full(t.data, dim)
        try:
            yield
        finally:
            for t, dim in self.tensors:
                t.data = self._local(t.data, dim)

    @contextlib.contextmanager
    def full(self):
        """The whole state, moments and EMA included, inside the block (a
        checkpoint); sharded again after."""
        self._map_rest(self._full)
        with self.gathered():
            try:
                yield
            finally:
                self._map_rest(self._local)

    def optimizer_step(self, opt):
        """opt.step() on this rank's shard of each sharded parameter (its
        gradient the full one's chunk), then the updated full parameters."""
        mine = [p for group in opt.param_groups for p in group["params"] if id(p) in self.dims]
        for p in mine:
            dim, grad = self.dims[id(p)], p.grad
            p.grad = None
            p.data = self._local(p.data, dim)
            if grad is not None:
                p.grad = self._local(grad, dim)
        opt.step()
        for p in mine:
            p.grad = None
            p.data = self._full(p.data, self.dims[id(p)])


class Mesh:
    """This rank's place in the (dp, sp, fsdp) mesh over the initialized
    process group, and the step's collectives. A world size that sp * fsdp
    does not divide raises, naming the sizes (mesh.py:43-44)."""

    def __init__(self, sp: int = 1, fsdp: int = 1):
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world % (sp * fsdp):
            raise ValueError(f"{world} devices not divisible by sp={sp} * fsdp={fsdp}")
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs an initialized process group "
                               "(train.setup.maybe_init_distributed)")
        self.world, self.sp, self.fsdp = world, sp, fsdp
        self.dp = world // (sp * fsdp)
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(self.dp, sp, fsdp)
        self.dp_index, self.sp_index, self.fsdp_index = (
            int(i) for i in np.argwhere(grid == self.rank)[0])
        self.dp_group = self._group([grid[:, s, f] for s in range(sp) for f in range(fsdp)])
        self.sp_group = self._group([grid[d, :, f] for d in range(self.dp) for f in range(fsdp)])
        self.fsdp_group = self._group([grid[d, s, :] for d in range(self.dp)
                                       for s in range(sp)])
        self.sp_ring = None
        if sp > 1:
            self.sp_ring = SpGroup(self.sp_group, sp, self.sp_index,
                                   tuple(int(r) for r in grid[self.dp_index, :, self.fsdp_index]))
        self.sharded = None

    def _group(self, rank_lists):
        """One process group per list (every rank creates every group, in one
        order); returns this rank's."""
        mine = None
        for ranks in rank_lists:
            ranks = [int(r) for r in ranks]
            g = dist.group.WORLD if len(ranks) == self.world else dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def __repr__(self):
        return (f"Mesh(world={self.world}, dp={self.dp}, sp={self.sp}, fsdp={self.fsdp}, "
                f"rank={self.rank})")

    def shard_state(self, step, ema=None):
        """Keep `step`'s state (and the EMA dict) as this rank's fsdp shards
        from now on (fsdp > 1); call after any restore."""
        if self.fsdp > 1:
            self.sharded = ShardedState(self, step, ema)

    def full_state(self):
        """A block inside which the whole state is in place (checkpoints)."""
        return self.sharded.full() if self.sharded is not None else contextlib.nullcontext()

    def reduce_grads_(self, grads):
        """Sum gradients over dp in place, one all_reduce per dtype."""
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for same in by_dtype.values():
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in same]), self.dp_group)
            for g, part in zip(same, flat.split([g.numel() for g in same])):
                g.copy_(part.view_as(g))

    def sum_(self, x):
        """A metric summed over dp, without a gradient."""
        return all_reduce_(x.detach().clone(), self.dp_group)

    def optimizer_step(self, opt):
        if self.sharded is None:
            opt.step()
        else:
            self.sharded.optimizer_step(opt)

    def run(self, step, batch, draws=None, subsampled=True):
        """One call of a TrainStep on this rank's batch: the draws of the
        global batch (drawn here when not given), the fsdp gather, the global
        batch and the ring in place; the losses summed over dp."""
        x = batch["video"]
        local = x.shape[0]
        if draws is None:
            draws = step.draw(local * self.dp, x.device)
        group = None
        if self.dp > 1:
            group = GlobalBatch(self.dp_group, self.dp_index, self.dp, local, subsampled)
            draws = group.localize(draws)
        with contextlib.ExitStack() as stack:
            if self.sharded is not None:
                stack.enter_context(self.sharded.gathered())
            stack.enter_context(batch_group.batch_group(group))
            if self.sp_ring is not None:
                stack.enter_context(sequence_parallel(self.sp_ring))
            metrics = step.run(batch, draws)
        losses = self.sum_(torch.stack([metrics["loss_d"], metrics["loss_g"]]))
        return dict(metrics, loss_d=losses[0], loss_g=losses[1])
