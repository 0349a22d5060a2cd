"""Fused non-local attention, forward and backward: hand-written CUDA kernels
for Hopper.

Replaces the three Pallas TPU kernels of txt2vid_tpu/ops/pallas_attention.py:

- K1 `fused_attention` / `_attn_kernel` (:43-131): o = softmax(theta @ phi^T) @ g
  with unscaled logits, plus the row log-sum-exp. Kernel `csrc/attention_fwd.cu`.
- K2 `_attn_bwd_dq_kernel` (:141-168, launched :225-245): dtheta = ds @ phi.
- K3 `_attn_bwd_dkv_kernel` (:171-204, launched :247-276): dphi = ds^T @ theta,
  dg = p^T @ do. K2 and K3 live in `csrc/attention_bwd.cu`.

with p = exp(s - lse), ds = p * (do @ g^T - delta) and delta = rowsum(do * o).
None of them writes the N x M map to device memory. The kernels are built with
nvcc for sm_90a and bound with ctypes (ops/_build.py).

What bounds them on an H100: at the generator's training shape (B, N, M, d, dv)
= (40, 1024, 256, 4, 16) K1 does 2*B*N*M*(d + dv) = 0.42 GFLOP, K2
2*B*N*M*(2d + dv) = 0.50 GFLOP and K3 2*B*N*M*(2d + 2dv) = 0.84 GFLOP and 10.5 M
exponentials each, against about 5 MB of traffic, so operations bound them.
At the cond-128 generator's (256, 4096, 1024, 8, 32) they do 86, 103 and 172
GFLOP and 1.07 G exponentials each against about 0.2 GB. All three run their
products on the tensor cores (mma.sync; float32 as three TF32 passes, d
zero-padded to the MMA depth of 8, or 16 in bfloat16; see the sources' notes).

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it computes its plain version (`*_reference`)
at any width. Each wrapper's `.launches` counts its kernel's launches, and
`.dtype_launches` the launches of each dtype's instantiation.
"""

import ctypes
import functools

import torch

from txt2vid_tpu_torch.ops import _build

# (d, dv) pairs the kernels are instantiated for: the generator's 2-D Attention
# at 32 channels (the 64-px flagship) and 64 channels (the cond-128 flagship's
# up0), and the discriminator's Attention3d at 128 channels
SUPPORTED_DV = {4: 16, 8: 32, 16: 64}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiles: K1 64 query rows per block; K2 4 warps of 16 query rows
# and 16-key chunks of 64-key stages, 1, 2 or 4 warps sharing a query tile when
# B * ceil(N / 64) blocks would leave SMs idle; K3 64 keys per block and
# stages of 64 query rows. K3 splits N across blocks when B * ceil(M / 64)
# blocks would not put _DKV_BLOCKS_PER_SM on every SM; each split handles a
# multiple of the 64-row stage
_FWD_ROWS_PER_BLOCK = 64
_DQ_WARPS = 4
_DQ_TILE_M = 64
_DQ_CHUNK_M = 16
_DKV_KEYS_PER_BLOCK = 64
_DKV_TILE_N = 64
_DKV_BLOCKS_PER_SM = 4
_DKV_MAX_SPLITS = 16


def fused_attention_reference(theta, phi, g, return_lse: bool = False):
    """Plain version of K1: einsum and softmax in f32, the softmax cast to g's
    dtype before it meets g (the TPU kernel's cast, pallas_attention.py:71),
    o cast to g's dtype."""
    logits = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    p = torch.softmax(logits, dim=-1).to(g.dtype).float()
    o = torch.einsum("bnm,bmv->bnv", p, g.float()).to(g.dtype)
    if return_lse:
        return o, torch.logsumexp(logits, dim=-1)
    return o


def _probs(theta, phi, lse):
    """p = exp(theta phi^T - lse) in f32, the backward's re-formed softmax."""
    s = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    return torch.exp(s - lse[..., None])


def _dlogits(p, g, do, delta):
    """ds = p * (do g^T - delta) in f32."""
    dp = torch.einsum("bnv,bmv->bnm", do.float(), g.float())
    return p * (dp - delta[..., None])


def attention_bwd_dq_reference(theta, phi, g, do, lse, delta):
    """Plain version of K2: dtheta = ds @ phi, cast to theta's dtype; ds is
    cast to phi's dtype before the product, as the TPU kernel does
    (pallas_attention.py:163)."""
    ds = _dlogits(_probs(theta, phi, lse), g, do, delta)
    return torch.einsum("bnm,bmd->bnd", ds.to(phi.dtype).float(),
                        phi.float()).to(theta.dtype)


def attention_bwd_dkv_reference(theta, phi, g, do, lse, delta):
    """Plain version of K3: dphi = ds^T @ theta and dg = p^T @ do, each cast to
    its input's dtype; p and ds are cast to do's and theta's dtype before
    their products, as the TPU kernel does (pallas_attention.py:191, :198)."""
    p = _probs(theta, phi, lse)
    ds = _dlogits(p, g, do, delta)
    dphi = torch.einsum("bnm,bnd->bmd", ds.to(theta.dtype).float(),
                        theta.float()).to(phi.dtype)
    dg = torch.einsum("bnm,bnv->bmv", p.to(do.dtype).float(), do.float()).to(g.dtype)
    return dphi, dg


def attention_delta(o, do):
    """delta = rowsum(do * o) in f32, (B, N): computed outside the kernels, as
    the JAX package does (pallas_attention.py:220-223)."""
    return (do.float() * o.float()).sum(dim=-1)


def fused_attention_bwd_reference(theta, phi, g, o, lse, do):
    """Plain version of the whole backward: (dtheta, dphi, dg)."""
    delta = attention_delta(o, do)
    dphi, dg = attention_bwd_dkv_reference(theta, phi, g, do, lse, delta)
    return attention_bwd_dq_reference(theta, phi, g, do, lse, delta), dphi, dg


def _check(theta, phi, g):
    """What any device takes: one device, one float32/bfloat16 dtype,
    (B, N, d), (B, M, d), (B, M, dv), contiguous. Returns (b, n, m, d, dv)."""
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
    if not (theta.is_contiguous() and phi.is_contiguous() and g.is_contiguous()):
        raise ValueError("fused_attention takes contiguous tensors")
    if theta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on CUDA or CPU, not {theta.device}")
    return b, n, m, d, dv


def _check_kernel(b, n, m, d, dv):
    """What the CUDA kernels take beyond `_check`."""
    if SUPPORTED_DV.get(d) != dv:
        raise ValueError(f"no kernel for (d, dv) = ({d}, {dv}); built for "
                         f"{sorted(SUPPORTED_DV.items())}")
    if n < 1 or m < 1 or not 1 <= b <= 65535:
        raise ValueError(f"unsupported sizes B={b} N={n} M={m}")
    if n * max(d, dv) >= 2**31 or m * dv >= 2**31:
        raise ValueError("N or M too large for the kernels' int32 row indices")


def _check_aligned(*tensors):
    """The kernels copy rows into shared memory in chunks of up to 16 bytes."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the attention kernels take tensors whose data start "
                             "on a 16-byte boundary; pass a fresh copy")


def _check_rows(name, t, shape, dtype):
    """A per-row operand of the backward: do (B, N, dv) or lse / delta (B, N)."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape} on CUDA, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _kernel(name):
    """A C entry point of the kernel libraries, built and typed on first use:
      t2v_attention_fwd(theta, phi, g, o, lse, b, n, m, d, dv, dtype, device, stream)
      t2v_attention_bwd_dq(theta, phi, g, do, lse, delta, dtheta, splits,
                           b, n, m, d, dv, dtype, device, stream)
      t2v_attention_bwd_dkv(theta, phi, g, do, lse, delta, dphi, dg, scratch,
                            splits, rows_per_split, b, n, m, d, dv, dtype, device, stream)
      t2v_attention_{fwd,bwd_dq,bwd_dkv}_occupancy(d, dv, dtype, device, out):
                            out = (blocks per SM, threads per block)
    Pointers and the stream are c_void_p ("p"): untyped, ctypes would pass 32
    bits; ints are c_int ("i")."""
    lib, sig = {"t2v_attention_fwd": ("attention_fwd", "ppppp" "iiiiiii" "p"),
                "t2v_attention_fwd_occupancy": ("attention_fwd", "iiii" "p"),
                "t2v_attention_bwd_dq": ("attention_bwd", "ppppppp" "iiiiiiii" "p"),
                "t2v_attention_bwd_dq_occupancy": ("attention_bwd", "iiii" "p"),
                "t2v_attention_bwd_dkv": ("attention_bwd", "ppppppppp" "iiiiiiiii" "p"),
                "t2v_attention_bwd_dkv_occupancy": ("attention_bwd", "iiii" "p")}[name]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int}[x] for x in sig]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def fused_attention(theta, phi, g, return_lse: bool = False):
    """K1. (B, N, d), (B, M, d), (B, M, dv) -> o (B, N, dv) in g's dtype
    [, lse (B, N) float32]. CUDA tensors launch the kernel; CPU tensors take
    the plain version. The output carries no autograd graph on CUDA: gradients
    go through ops/attention.py's FusedAttention."""
    b, n, m, d, dv = _check(theta, phi, g)
    if theta.device.type == "cpu":
        return fused_attention_reference(theta, phi, g, return_lse)
    _check_kernel(b, n, m, d, dv)
    _check_aligned(theta, phi, g)
    o = torch.empty((b, n, dv), dtype=g.dtype, device=g.device)
    lse = torch.empty((b, n), dtype=torch.float32, device=g.device) \
        if return_lse else None
    err = _kernel("t2v_attention_fwd")(
        theta.data_ptr(), phi.data_ptr(), g.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, n, m, d, dv, _DTYPE_CODE[g.dtype], theta.device.index, _stream(theta))
    _raise_on(err, "attention_fwd")
    fused_attention.launches += 1
    fused_attention.dtype_launches[g.dtype] += 1
    return (o, lse) if return_lse else o


def _check_bwd(theta, phi, g, do, lse, delta):
    b, n, m, d, dv = _check(theta, phi, g)
    if theta.device.type == "cuda":
        _check_kernel(b, n, m, d, dv)
        _check_rows("do", do, (b, n, dv), g.dtype)
        _check_rows("lse", lse, (b, n), torch.float32)
        _check_rows("delta", delta, (b, n), torch.float32)
        _check_aligned(theta, phi, g, do)
    return b, n, m, d, dv


def attention_bwd_dq(theta, phi, g, do, lse, delta):
    """K2. dtheta (B, N, d) in theta's dtype from the forward's inputs, the
    output gradient do (B, N, dv), lse and delta (B, N) float32."""
    b, n, m, d, dv = _check_bwd(theta, phi, g, do, lse, delta)
    if theta.device.type == "cpu":
        return attention_bwd_dq_reference(theta, phi, g, do, lse, delta)
    dtheta = torch.empty_like(theta)
    err = _kernel("t2v_attention_bwd_dq")(
        theta.data_ptr(), phi.data_ptr(), g.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dtheta.data_ptr(),
        dq_splits(b, n, m, sm_count(theta.device.index)),
        b, n, m, d, dv, _DTYPE_CODE[g.dtype], theta.device.index, _stream(theta))
    _raise_on(err, "attention_bwd_dq")
    attention_bwd_dq.launches += 1
    attention_bwd_dq.dtype_launches[g.dtype] += 1
    return dtheta


@functools.cache
def sm_count(device_index):
    """Streaming multiprocessors of the CUDA device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def dq_splits(b, n, m, sms):
    """How many of a K2 block's 4 warps share one 16-row query tile (1, 2 or
    4): the fewest that give `sms` SMs a block each, and no more than M has
    16-key chunks. Slot s of `splits` takes chunks s, s + splits, ... of each
    64-key stage; a block holds 4 / splits query tiles."""
    chunks = -(-min(m, _DQ_TILE_M) // _DQ_CHUNK_M)
    splits = 1
    while (2 * splits <= min(_DQ_WARPS, chunks)
           and b * -(-n * splits // (16 * _DQ_WARPS)) < sms):
        splits *= 2
    return splits


def dkv_splits(b, n, m, sms):
    """(splits, rows_per_split): how K3 cuts N across blocks so that about
    _DKV_BLOCKS_PER_SM blocks are in flight on each of `sms` SMs. Split s
    covers query rows [s * rows, min(n, (s + 1) * rows)), a whole number of
    64-row stages, none empty. 1 split writes the outputs directly; more go
    through an f32 scratch and a fixed-order reduction."""
    blocks = b * -(-m // _DKV_KEYS_PER_BLOCK)
    tiles = -(-n // _DKV_TILE_N)
    want = max(1, min(tiles, _DKV_MAX_SPLITS, -(-_DKV_BLOCKS_PER_SM * sms // blocks)))
    rows = -(-tiles // want) * _DKV_TILE_N
    return -(-n // rows), rows


def attention_bwd_dkv(theta, phi, g, do, lse, delta):
    """K3. (dphi (B, M, d), dg (B, M, dv)) in phi's and g's dtype; arguments as
    for attention_bwd_dq."""
    b, n, m, d, dv = _check_bwd(theta, phi, g, do, lse, delta)
    if theta.device.type == "cpu":
        return attention_bwd_dkv_reference(theta, phi, g, do, lse, delta)
    dphi = torch.empty_like(phi)
    dg = torch.empty_like(g)
    splits, rows = dkv_splits(b, n, m, sm_count(theta.device.index))
    scratch = (torch.empty((splits, b * m * (d + dv)), dtype=torch.float32,
                           device=g.device) if splits > 1 else None)
    err = _kernel("t2v_attention_bwd_dkv")(
        theta.data_ptr(), phi.data_ptr(), g.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dphi.data_ptr(), dg.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, splits, rows,
        b, n, m, d, dv, _DTYPE_CODE[g.dtype], theta.device.index, _stream(theta))
    _raise_on(err, "attention_bwd_dkv")
    attention_bwd_dkv.launches += 1
    attention_bwd_dkv.dtype_launches[g.dtype] += 1
    return dphi, dg


def fused_attention_bwd(theta, phi, g, o, lse, do):
    """(forward inputs, o, lse, do) -> (dtheta, dphi, dg): delta with a torch
    op, then K2 and K3 (their plain versions for CPU tensors)."""
    delta = attention_delta(o, do)
    dtheta = attention_bwd_dq(theta, phi, g, do, lse, delta)
    dphi, dg = attention_bwd_dkv(theta, phi, g, do, lse, delta)
    return dtheta, dphi, dg


def occupancy(kernel, shape, dtype=torch.float32, device_index=0):
    """How K1 ("attention_fwd"), K2 ("attention_bwd_dq") or K3
    ("attention_bwd_dkv") fills the card at (B, N, M, d, dv): blocks per SM
    that registers and shared memory allow, warps per block, blocks in the
    grid, and the resident warps per SM, the fewer of what the SM holds and
    what the grid supplies."""
    b, n, m, d, dv = shape
    out = (ctypes.c_int * 2)()
    err = _kernel(f"t2v_{kernel}_occupancy")(d, dv, _DTYPE_CODE[dtype], device_index, out)
    _raise_on(err, f"{kernel} occupancy")
    sms = sm_count(device_index)
    if kernel == "attention_fwd":
        grid = b * -(-n // _FWD_ROWS_PER_BLOCK)
    elif kernel == "attention_bwd_dq":
        grid = b * -(-n * dq_splits(b, n, m, sms) // (16 * _DQ_WARPS))
    else:
        grid = b * -(-m // _DKV_KEYS_PER_BLOCK) * dkv_splits(b, n, m, sms)[0]
    warps = out[1] // 32
    return {"blocks_per_sm": out[0], "warps_per_block": warps, "grid_blocks": grid,
            "resident_warps_per_sm": min(out[0] * warps, grid * warps / sms)}


for _wrapper in (fused_attention, attention_bwd_dq, attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.dtype_launches = dict.fromkeys(_DTYPE_CODE, 0)
