"""Fused non-local attention forward: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `fused_attention` / `_attn_kernel`
(txt2vid_tpu/ops/pallas_attention.py:43-131): o = softmax(theta @ phi^T) @ g with
unscaled logits, plus the row log-sum-exp, without the N x M map in device
memory. The kernel is `csrc/attention_fwd.cu`, built with nvcc for sm_90a and
bound with ctypes (ops/_build.py).

What bounds it on an H100: at the generator's serving shape (B, N, M, d, dv) =
(128, 1024, 256, 4, 16) it moves about 13.6 MB but does 2*B*N*M*(d+dv) = 1.34
GFLOP of scalar f32 work and B*N*M exponentials, so the CUDA cores' f32 rate is
the floor (d = 4 is below the tensor cores' K of 16). The design keeps that work
in registers: one thread per query row, phi and g tiles broadcast from shared
memory, and one accumulator rescale per chunk of keys (see the source's note).

`fused_attention` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors it computes the plain version,
`fused_attention_reference`. `fused_attention.launches` counts kernel launches.
"""

import ctypes
import functools

import torch

from txt2vid_tpu_torch.ops import _build

# (d, dv) pairs the kernel is instantiated for: the generator's 2-D Attention at
# 32 channels and the discriminator's Attention3d at 128 channels
SUPPORTED_DV = {4: 16, 16: 64}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(theta, phi, g, return_lse: bool = False):
    """Plain version: einsum and softmax in f32, o cast to g's dtype."""
    logits = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    o = torch.einsum("bnm,bmv->bnv", torch.softmax(logits, dim=-1), g.float())
    o = o.to(g.dtype)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1)
    return o


def _check(theta, phi, g):
    if not (theta.device == phi.device == g.device):
        raise ValueError(f"inputs on different devices: {theta.device}, "
                         f"{phi.device}, {g.device}")
    if not (theta.dtype == phi.dtype == g.dtype) or theta.dtype not in _DTYPE_CODE:
        raise TypeError("fused_attention takes float32 or bfloat16 inputs of one "
                        f"dtype, got {theta.dtype}, {phi.dtype}, {g.dtype}")
    if theta.dim() != 3 or phi.dim() != 3 or g.dim() != 3:
        raise ValueError("fused_attention takes (B, N, d), (B, M, d), (B, M, dv)")
    b, n, d = theta.shape
    bp, m, dp = phi.shape
    bg, mg, dv = g.shape
    if bp != b or bg != b or dp != d or mg != m:
        raise ValueError(f"shape mismatch: theta {tuple(theta.shape)}, phi "
                         f"{tuple(phi.shape)}, g {tuple(g.shape)}")
    if SUPPORTED_DV.get(d) != dv:
        raise ValueError(f"no kernel for (d, dv) = ({d}, {dv}); built for "
                         f"{sorted(SUPPORTED_DV.items())}")
    if n < 1 or m < 1 or not 1 <= b <= 65535:
        raise ValueError(f"unsupported sizes B={b} N={n} M={m}")
    if n * max(d, dv) >= 2**31 or m * dv >= 2**31:
        raise ValueError("N or M too large for the kernel's int32 row indices")
    if not (theta.is_contiguous() and phi.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_attention takes contiguous tensors")
    return b, n, m, d, dv


@functools.cache
def _kernel():
    """The C entry point t2v_attention_fwd(theta, phi, g, o, lse, b, n, m, d, dv,
    dtype, device, stream), built and typed on first use."""
    fn = _build.load("attention_fwd").t2v_attention_fwd
    # pointers and the stream as c_void_p: untyped, ctypes would pass 32 bits
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_attention(theta, phi, g, return_lse: bool = False):
    """(B, N, d), (B, M, d), (B, M, dv) -> o (B, N, dv) in g's dtype
    [, lse (B, N) float32]. CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    b, n, m, d, dv = _check(theta, phi, g)
    if theta.device.type == "cpu":
        return fused_attention_reference(theta, phi, g, return_lse)
    if theta.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU, not {theta.device}")

    kernel = _kernel()
    o = torch.empty((b, n, dv), dtype=g.dtype, device=g.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=g.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = kernel(theta.data_ptr(), phi.data_ptr(), g.data_ptr(), o.data_ptr(),
                 lse.data_ptr() if lse is not None else None,
                 b, n, m, d, dv, _DTYPE_CODE[g.dtype], theta.device.index, stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed: cudaError {err}")
    fused_attention.launches += 1
    return (o, lse) if return_lse else o


fused_attention.launches = 0
