"""Non-local (self-attention) core ops (counterpart of txt2vid_tpu/ops/attention.py).

From 1x1-conv projections theta (N, d), phi (M, d), g (M, dv), with M = N/4 after
a 2x2 max-pool, the non-local blocks compute

    beta = softmax(theta @ phi^T, axis=-1)      # (N, M), NO 1/sqrt(d)
    o    = beta @ g                             # (N, dv)

`attention_core` is the plain PyTorch version. `attention_core_auto` dispatches a
CUDA tensor to the fused kernel (ops/fused_attention.py) and a CPU tensor to the
plain version, unless `no_kernel()` is active or the caller passes
use_kernel=False. Only the forward is ported; gradients wait for the training
slice and its backward kernels.
"""

import contextlib
import contextvars

import torch

from txt2vid_tpu_torch.ops.fused_attention import fused_attention

_KERNEL_DISABLED = contextvars.ContextVar("txt2vid_no_kernel", default=False)


def attention_core(theta, phi, g):
    """(B, N, d), (B, M, d), (B, M, dv) -> (B, N, dv). Unscaled softmax attention,
    logits in f32, beta cast to g's dtype (txt2vid_tpu/ops/attention.py:24-29)."""
    logits = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    beta = torch.softmax(logits, dim=-1).to(g.dtype)
    return torch.einsum("bnm,bmv->bnv", beta.float(), g.float()).to(g.dtype)


@contextlib.contextmanager
def no_kernel():
    """Force the plain attention path inside the block (the counterpart of
    `no_pallas`, txt2vid_tpu/ops/attention.py:81-92)."""
    token = _KERNEL_DISABLED.set(True)
    try:
        yield
    finally:
        _KERNEL_DISABLED.reset(token)


def attention_core_auto(theta, phi, g, use_kernel: bool = True):
    """The fused kernel for CUDA tensors (plain version for CPU tensors, inside
    the wrapper), or `attention_core` under no_kernel() / use_kernel=False."""
    if not use_kernel or _KERNEL_DISABLED.get():
        return attention_core(theta, phi, g)
    return fused_attention(theta, phi, g)
