"""Ring attention: non-local attention with its tokens split over the ranks
of a sequence-parallel group (counterpart of txt2vid_tpu/ops/ring_attention.py).

Semantics are ops.attention.attention_core's (unscaled logits). Each of the S
ranks of the group takes its N/S queries and M/S keys and values of the
replicated (B, N, d), (B, M, d), (B, M, dv) inputs; the key/value blocks
rotate around the ring, S - 1 times, by send/recv, and each rank merges the
blocks' flash statistics (o, lse):

    lse = logaddexp(lse_a, lse_b);  o = o_a * exp(lse_a - lse) + o_b * exp(lse_b - lse)

(ring_attention.py:54-58). One rotation's block is K1 with its row
log-sum-exp (`ops.fused_attention.fused_attention`: the kernel on CUDA
tensors, its plain version on CPU tensors, or the plain version when the
module asks for no kernel), its o cast from g's dtype to float32 before the
merge, as ring_attention.py:45-50 does. After the ring each rank's (N/S, dv)
block is gathered back to the replicated (B, N, dv).

The backward is a plain blockwise recompute (ring_attention.py:126-134):
per rotation one (N/S, M/S) tile re-forms p = exp(theta phi^T - lse) from
the saved lse, and the dphi and dg accumulators travel with their key/value
block, S rotations, so each comes home summed; the three gradients are
gathered back to the replicated layout. K2 and K3 are not on this path, and
the (N, M) map is never formed. The backward is first-order only: the
gradient penalty's double backward takes the plain attention under
no_kernel() before the ring is reached.

The forward and the backward are written once (`ring_forward`,
`ring_backward`) over the ranks a ring holds and its rotation: an `SpGroup`
holds this rank and rotates by send/recv; a `LocalRing` holds all of them
in one process and rotates a list (`ring_attention_local`,
`ring_backward_local`: the chip check and the tests hold the ring to one K1
over all of M with them).
"""

from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from txt2vid_tpu_torch.ops.fused_attention import fused_attention, fused_attention_reference


@dataclass(frozen=True)
class SpGroup:
    """A sequence-parallel group: its process group, size, this rank's index
    in it and the global ranks of the ring, in order. As a ring (see
    `ring_forward`) it holds this rank alone."""

    group: object
    size: int
    index: int
    ranks: tuple

    @property
    def next(self) -> int:
        return self.ranks[(self.index + 1) % self.size]

    @property
    def prev(self) -> int:
        return self.ranks[(self.index - 1) % self.size]

    @property
    def held(self):
        return (self.index,)

    def rotate(self, per_rank):
        """One ring step: this rank's tensors go to the next rank, the
        previous rank's come in (send/recv over the group)."""
        from txt2vid_tpu_torch.parallel.collectives import rotate
        return [rotate(per_rank[0], self.group, self.next, self.prev)]


@dataclass(frozen=True)
class LocalRing:
    """The ring of `size` ranks in one process: it holds every rank, in ring
    order, and a rotation hands each rank's tensors to the next."""

    size: int

    @property
    def held(self):
        return tuple(range(self.size))

    def rotate(self, per_rank):
        return per_rank[-1:] + per_rank[:-1]


def block_attention(theta, phi, g, use_kernel: bool = True):
    """One block: K1 (or its plain version) with its lse; o as float32."""
    fn = fused_attention if use_kernel else fused_attention_reference
    o, lse = fn(theta, phi, g, return_lse=True)
    return o.float(), lse


def merge(o_a, lse_a, o_b, lse_b):
    lse = torch.logaddexp(lse_a, lse_b)
    return (o_a * torch.exp(lse_a - lse)[..., None]
            + o_b * torch.exp(lse_b - lse)[..., None]), lse


def block_backward(theta, phi_c, g_c, do, lse, delta):
    """One tile's plain recompute in float32: (dtheta, dphi_c, dg_c) with
    p = exp(theta phi_c^T - lse) and ds = p * (do g_c^T - delta)."""
    s = torch.einsum("bnd,bmd->bnm", theta.float(), phi_c.float())
    p = torch.exp(s - lse[..., None])
    ds = p * (torch.einsum("bnv,bmv->bnm", do.float(), g_c.float()) - delta[..., None])
    return (torch.einsum("bnm,bmd->bnd", ds, phi_c.float()),
            torch.einsum("bnm,bnd->bmd", ds, theta.float()),
            torch.einsum("bnm,bnv->bmv", p, do.float()))


def blocks(x, ring):
    """The held ranks' blocks of a replicated (B, N, ...) tensor (dim 1)."""
    n = x.shape[1] // ring.size
    return [x[:, k * n:(k + 1) * n].contiguous() for k in ring.held]


def ring_forward(ths, kvs, ring, use_kernel: bool = True):
    """The ring's forward for the ranks `ring` holds: rank k's queries
    ths[k] meet its own key/value block kvs[k] = (phi_k, g_k), then each
    received from the previous rank, merged from o = 0 and lse = -inf.
    Returns the per-rank (o float32, lse) lists."""
    os_, lses = [], []
    for th, (_, g_k) in zip(ths, kvs):
        b, n, _ = th.shape
        os_.append(torch.zeros((b, n, g_k.shape[-1]), dtype=torch.float32, device=th.device))
        lses.append(torch.full((b, n), float("-inf"), dtype=torch.float32, device=th.device))
    for i in range(ring.size):
        for k, (th, (ph, gg)) in enumerate(zip(ths, kvs)):
            os_[k], lses[k] = merge(os_[k], lses[k], *block_attention(th, ph, gg, use_kernel))
        if i < ring.size - 1:
            kvs = ring.rotate(kvs)
    return os_, lses


def ring_backward(ths, kvs, o32s, lses, d_os, ring):
    """The blockwise recompute for the ranks `ring` holds, from the forward's
    per-rank o and lse: per-rank float32 (dtheta, dphi, dg) lists. The dphi
    and dg accumulators travel with their key/value block; the last rotation
    brings them home alone."""
    dths, carry = [], []
    for th, (ph, gg) in zip(ths, kvs):
        dths.append(torch.zeros(th.shape, dtype=torch.float32, device=th.device))
        carry.append([ph, gg, torch.zeros(ph.shape, dtype=torch.float32, device=ph.device),
                      torch.zeros(gg.shape, dtype=torch.float32, device=gg.device)])
    deltas = [(d_o.float() * o32).sum(dim=-1) for d_o, o32 in zip(d_os, o32s)]
    for i in range(ring.size):
        for k, c in enumerate(carry):
            a, b, d = block_backward(ths[k], c[0], c[1], d_os[k], lses[k], deltas[k])
            dths[k] += a
            c[2], c[3] = c[2] + b, c[3] + d
        if i < ring.size - 1:
            carry = ring.rotate(carry)
        else:
            carry = ring.rotate([c[2:] for c in carry])
    return dths, [c[0] for c in carry], [c[1] for c in carry]


def ring_attention_local(theta, phi, g, size: int, use_kernel: bool = True):
    """The ring of `size` ranks as a `LocalRing` in one process, through the
    body RingAttention runs. Returns (o in g's dtype, o float32, lse),
    (B, N, ...)."""
    ring = LocalRing(size)
    o32s, lses = ring_forward(blocks(theta, ring), list(zip(blocks(phi, ring), blocks(g, ring))),
                              ring, use_kernel)
    o32 = torch.cat(o32s, dim=1)
    return o32.to(g.dtype), o32, torch.cat(lses, dim=1)


def ring_backward_local(theta, phi, g, o32, lse, do, size: int):
    """RingAttention's backward as a `LocalRing` in one process:
    (dtheta, dphi, dg) in the inputs' dtypes."""
    ring = LocalRing(size)
    grads = ring_backward(blocks(theta, ring), list(zip(blocks(phi, ring), blocks(g, ring))),
                          blocks(o32, ring), blocks(lse, ring), blocks(do, ring), ring)
    return tuple(torch.cat(d, dim=1).to(x.dtype) for d, x in zip(grads, (theta, phi, g)))


class RingAttention(torch.autograd.Function):
    """softmax(theta phi^T) g over a sequence-parallel group: replicated
    inputs, replicated output and gradients."""

    @staticmethod
    def forward(ctx, theta, phi, g, sp: SpGroup, use_kernel: bool):
        from txt2vid_tpu_torch.parallel.collectives import all_gather_cat
        (th,), (ph,), (gg,) = blocks(theta, sp), blocks(phi, sp), blocks(g, sp)
        (o32,), (lse,) = ring_forward([th], [(ph, gg)], sp, use_kernel)
        ctx.save_for_backward(th, ph, gg, o32, lse)
        ctx.sp = sp
        return all_gather_cat(o32.to(g.dtype), sp.group, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        from txt2vid_tpu_torch.parallel.collectives import all_gather_cat
        th, ph, gg, o32, lse = ctx.saved_tensors
        sp = ctx.sp
        grads = ring_backward([th], [(ph, gg)], [o32], [lse], blocks(do, sp), sp)
        return (*(all_gather_cat(d.to(x.dtype), sp.group, dim=1)
                  for (d,), x in zip(grads, (th, ph, gg))), None, None)


def ring_attention(theta, phi, g, sp: SpGroup, use_kernel: bool = True):
    """Sequence-split softmax(theta phi^T) g over `sp`; N and M must divide by
    its size."""
    if theta.shape[1] % sp.size or phi.shape[1] % sp.size:
        raise ValueError(f"N={theta.shape[1]} and M={phi.shape[1]} must divide by "
                         f"sp={sp.size}")
    return RingAttention.apply(theta, phi, g, sp, use_kernel)
