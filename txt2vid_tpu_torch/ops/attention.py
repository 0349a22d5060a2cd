"""Non-local (self-attention) core ops (counterpart of txt2vid_tpu/ops/attention.py).

From 1x1-conv projections theta (N, d), phi (M, d), g (M, dv), with M = N/4 after
a 2x2 max-pool, the non-local blocks compute

    beta = softmax(theta @ phi^T, axis=-1)      # (N, M), NO 1/sqrt(d)
    o    = beta @ g                             # (N, dv)

`attention_core` is the plain PyTorch version. `FusedAttention` is the
autograd Function around the fused kernels (ops/fused_attention.py), the
counterpart of the JAX package's custom VJP (attention.py:48-73): its forward
runs K1, its backward K2 and K3, re-forming the softmax from the saved row
log-sum-exp. For CPU tensors both directions run the kernels' plain versions.
`attention_core_auto` routes to FusedAttention unless `no_kernel()` is active
or the caller passes use_kernel=False.
"""

import contextlib
import contextvars

import torch
from torch.autograd.function import once_differentiable

from txt2vid_tpu_torch.ops.fused_attention import fused_attention, fused_attention_bwd

_KERNEL_DISABLED = contextvars.ContextVar("txt2vid_no_kernel", default=False)


def attention_core(theta, phi, g):
    """(B, N, d), (B, M, d), (B, M, dv) -> (B, N, dv). Unscaled softmax attention,
    logits in f32, beta cast to g's dtype (txt2vid_tpu/ops/attention.py:24-29)."""
    logits = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    beta = torch.softmax(logits, dim=-1).to(g.dtype)
    return torch.einsum("bnm,bmv->bnv", beta.float(), g.float()).to(g.dtype)


class FusedAttention(torch.autograd.Function):
    """o = softmax(theta phi^T) g through K1; gradients through K2 and K3.

    The forward asks K1 for the row log-sum-exp and saves (theta, phi, g, o,
    lse). The backward is first-order only (`once_differentiable`): a double
    backward raises instead of returning a wrong second-order gradient; the
    gradient penalty takes the plain path under no_kernel()."""

    @staticmethod
    def forward(ctx, theta, phi, g):
        o, lse = fused_attention(theta, phi, g, return_lse=True)
        ctx.save_for_backward(theta, phi, g, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        # create_graph=True runs the backward with grad mode on; the
        # once_differentiable body alone would build no graph for the
        # dependence through the saved tensors and drop that term silently
        if torch.is_grad_enabled():
            raise RuntimeError("FusedAttention has no second-order gradient; "
                               "differentiate twice under no_kernel()")
        return _first_order_backward(ctx, do)


@once_differentiable
def _first_order_backward(ctx, do):
    theta, phi, g, o, lse = ctx.saved_tensors
    return fused_attention_bwd(theta, phi, g, o, lse, do.contiguous())


@contextlib.contextmanager
def kernel_disabled(disabled: bool):
    """Inside the block the attention takes its plain path if `disabled`, the
    kernels' otherwise, whatever an enclosing block said."""
    token = _KERNEL_DISABLED.set(disabled)
    try:
        yield
    finally:
        _KERNEL_DISABLED.reset(token)


def no_kernel():
    """Force the plain attention path inside the block (the counterpart of
    `no_pallas`, txt2vid_tpu/ops/attention.py:81-92)."""
    return kernel_disabled(True)


def kernels_disabled() -> bool:
    """Whether a no_kernel() block is active here."""
    return _KERNEL_DISABLED.get()


def attention_core_auto(theta, phi, g, use_kernel: bool = True):
    """The fused kernels (their plain versions for CPU tensors): through
    FusedAttention when a gradient is wanted, else K1 alone without the
    log-sum-exp. `attention_core` under no_kernel() / use_kernel=False."""
    if not use_kernel or _KERNEL_DISABLED.get():
        return attention_core(theta, phi, g)
    if torch.is_grad_enabled() and (theta.requires_grad or phi.requires_grad
                                    or g.requires_grad):
        return FusedAttention.apply(theta, phi, g)
    return fused_attention(theta, phi, g)
