"""3x3 float32 convolutions (stride 1, padding 1) on the tensor cores: the
generators' Conv2d layers, their input gradient and their weight gradient.

The kernels (`csrc/conv3x3.cu`, built by ops/_build.py) replace no TPU
kernel: the JAX package leaves its convolutions to XLA. They replace cuDNN's
float32 convolutions, which run on the SIMT units (67 TFLOP/s on an H100),
by implicit GEMMs on the tensor cores, float32 as three TF32 passes (165
TFLOP/s), summed from zero a few k-steps of 8 at a time and added in float32
with round-to-nearest. Operations bound them at every shape of the cond-128
generator (19 to 618 GFLOP a call against at most 0.3 GB of traffic). The
convolution and the input gradient run on warpgroup MMAs (wgmma), the weight
gradient on mma.sync; the source's note says how the design meets the bound.

Three ops, each a `torch.autograd.Function` whose backward calls the other
two, so a gradient through a gradient stays on them:

- `Conv3x3`: y = conv(x, w) + b;
- `Conv3x3InputGrad`: dx = conv(dy, w flipped and transposed), read through
  the kernel's indexing;
- `Conv3x3WeightGrad`: dw = the sum over positions of dy times x's taps.

CUDA tensors launch the kernels (float32 only; anything else raises); CPU
tensors take the plain versions, `F.conv2d`, `torch.nn.grad.conv2d_input`
and `torch.nn.grad.conv2d_weight`, at any dtype. Each wrapper's `.launches`
counts its kernel's launches, `conv3x3_reduce.launches` those of the
fixed-order sum that a split reduction adds. Tile sizes and splits come
from `conv_plan` and `wgrad_plan`, plain Python of the shapes and the SM
count.
"""

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from txt2vid_tpu_torch.ops import _build
from txt2vid_tpu_torch.ops.fused_attention import sm_count

TAPS = 9
# the convolution kernel: 128 positions a block (two warpgroups of 64); its
# two block tiles' (output channels, threads, blocks one SM's registers hold:
# two, as its __launch_bounds__ ask)
CONV_SLOTS = 128
CONV_TILES = ((64, 256, 2), (32, 256, 2))
CONV_STAGES = 2
CHUNK = 8                   # input channels per pipeline stage
STAGES = 3                  # the weight gradient's
# the weight gradient: 32 positions a chunk, 16 input channels a block;
# (output channels, threads, blocks one SM's registers hold) of its three
# block tiles
WGRAD_SLOTS = 32
WGRAD_CHANNELS = 16
WGRAD_TILES = ((32, 64, 4), (64, 128, 2), (128, 256, 1))
MAX_HALO_PER_THREAD = 4
SMEM_LIMIT = 227 * 1024
SCRATCH_LIMIT = 64 * 2 ** 20    # bytes of partial sums a split reduction may hold
MIN_WAVE_FILL = 0.85
# the cond-128 generator's float32 3x3 convolutions in a training step, (n,
# cin, cout, h, w): the ConvLSTM's 4x4 gate convolution, then the ten UpBlock
# ones (base.up0-2 and up0-1, conv1 and conv2 each); the tiles are tuned and
# checked at these
COND128_SHAPES = [(32, 1024, 4096, 4, 4),
                  (1024, 1024, 512, 8, 8), (1024, 512, 512, 8, 8),
                  (1024, 512, 256, 16, 16), (1024, 256, 256, 16, 16),
                  (1024, 256, 128, 32, 32), (1024, 128, 128, 32, 32),
                  (256, 128, 64, 64, 64), (256, 64, 64, 64, 64),
                  (64, 64, 32, 128, 128), (64, 32, 32, 128, 128)]


def conv3x3_reference(x, w, bias=None):
    """Plain version of the convolution: F.conv2d, stride 1, padding 1."""
    return F.conv2d(x, w, bias, padding=1)


def conv3x3_input_grad_reference(dy, w):
    """Plain version of the input gradient."""
    n, _, h, wd = dy.shape
    return torch.nn.grad.conv2d_input((n, w.shape[1], h, wd), w, dy, padding=1)


def conv3x3_weight_grad_reference(x, dy):
    """Plain version of the weight gradient."""
    return torch.nn.grad.conv2d_weight(x, (dy.shape[1], x.shape[1], 3, 3), dy, padding=1)


def position_tile(n, h, w, slots, halo_cap):
    """(ti, th, tw): a tile of at most `slots` output positions, ti images x
    th rows x tw columns, whose halo ti x (th + 2) x (tw + 2) holds at most
    `halo_cap` values."""
    tw = min(w, 32)
    th = min(h, max(1, slots // tw))
    ti = min(n, max(1, slots // (th * tw))) if th == h else 1
    while ti > 1 and ti * (th + 2) * (tw + 2) > halo_cap:
        ti -= 1
    while th > 1 and ti * (th + 2) * (tw + 2) > halo_cap:
        th -= 1
    if ti * (th + 2) * (tw + 2) > halo_cap:
        raise ValueError(f"no position tile of a {h}x{w} plane fits {halo_cap} halo values")
    return ti, th, tw


def _splits(blocks, wave, most):
    """How many ways to split a reduction over blocks: 1 where `blocks` make
    two waves of `wave` or more, else the fewest splits (at most `most`)
    whose blocks fill their waves to MIN_WAVE_FILL, or the best filling."""
    def fill(s):
        total = blocks * s
        return total / (math.ceil(total / wave) * wave)
    if blocks >= 2 * wave:
        return 1
    best = 1
    for s in range(1, max(1, most) + 1):
        if fill(s) >= MIN_WAVE_FILL:
            return s
        if fill(s) > fill(best):
            best = s
    return best


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    cfg: int
    bn: int
    threads: int
    ti: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    co_tiles: int
    cs: int
    sb: int
    cps: int
    pos_tiles: int
    splits: int
    smem_bytes: int


def _resident(table, smem_bytes):
    """Blocks of a kernel one SM holds: its tile table's count, or fewer
    where shared memory (228 KB an SM, 1 KB of it reserved a block) holds
    fewer."""
    return max(1, min(table, (SMEM_LIMIT + 1024) // (smem_bytes + 1024)))


@functools.lru_cache(maxsize=256)
def conv_plan(n, cin, cout, h, w, flip, sms):
    """The convolution kernel's tiles for an (n, cin, h, w) input and cout
    output channels (flip: the input gradient's, whose cin is dy's channels
    and cout x's), on `sms` SMs."""
    cfg = 0 if cout > 32 else 1
    bn, threads, resident = CONV_TILES[cfg]
    ti, th, tw = position_tile(n, h, w, CONV_SLOTS, MAX_HALO_PER_THREAD * threads)
    halo = ti * (th + 2) * (tw + 2)
    # Shared-memory strides that put a warp's reads on distinct banks. A
    # fragment reads 8 slots (mostly consecutive halo columns) at each of 4
    # channels: channels 8 banks apart, a stride of 8 mod 16. The weight's
    # split reads 8 rows at 4 columns 9 apart (under flip the roles swap):
    # rows of 76 floats, 12 banks apart, or of 9 bn + 8 (9 bn is a multiple
    # of 32), 8 banks apart.
    cs = halo + (8 - halo) % 16
    if flip:
        sb, rows = bn * TAPS + 8, CHUNK
    else:
        sb, rows = CHUNK * TAPS + 4, bn
    # the weight split into hi and lo for the warpgroup MMAs, and the ring of
    # staged halos and weights
    smem = (2 * TAPS * bn * CHUNK + CONV_STAGES * (CHUNK * cs + rows * sb)) * 4
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    pos_tiles = -(-n // ti) * tiles_h * tiles_w
    co_tiles = -(-cout // bn)
    chunks = -(-cin // CHUNK)
    most = min(chunks, SCRATCH_LIMIT // max(1, 4 * n * cout * h * w))
    splits = _splits(pos_tiles * co_tiles, sms * _resident(resident, smem), most)
    cps = -(-chunks // splits)
    return ConvPlan(cfg, bn, threads, ti, th, tw, tiles_h, tiles_w, co_tiles, cs, sb, cps,
                    pos_tiles, -(-chunks // cps), smem)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    cfg: int
    bm: int
    threads: int
    ti: int
    th: int
    tw: int
    tiles_h: int
    tiles_w: int
    nq: int
    qps: int
    cs: int
    ci_tiles: int
    co_tiles: int
    splits: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def wgrad_plan(n, cin, cout, h, w, sms):
    """The weight-gradient kernel's tiles for an (n, cin, h, w) input and an
    (n, cout, h, w) output gradient, on `sms` SMs."""
    cfg = 2 if cout >= 96 else 1 if cout >= 48 else 0
    bm, threads, resident = WGRAD_TILES[cfg]
    ti, th, tw = position_tile(n, h, w, WGRAD_SLOTS, MAX_HALO_PER_THREAD * threads)
    halo = ti * (th + 2) * (tw + 2)
    # B reads 8 input channels at 4 consecutive slots: a channel stride of 4
    # mod 8 puts the channels on 8 distinct multiples of 4 banks
    cs = halo + (4 - halo) % 8
    smem = STAGES * (bm * (WGRAD_SLOTS + 4) + WGRAD_CHANNELS * cs) * 4
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    nq = -(-n // ti) * tiles_h * tiles_w
    co_tiles, ci_tiles = -(-cout // bm), -(-cin // WGRAD_CHANNELS)
    most = min(nq, SCRATCH_LIMIT // (4 * cout * cin * TAPS))
    splits = _splits(co_tiles * ci_tiles, sms * _resident(resident, smem), most)
    qps = -(-nq // splits)
    return WgradPlan(cfg, bm, threads, ti, th, tw, tiles_h, tiles_w, nq, qps, cs, ci_tiles,
                     co_tiles, -(-nq // qps), smem)


@functools.cache
def _kernel(name):
    """A C entry point of the convolution library, built and typed on first use:
      t2v_conv3x3(x, w, bias, y, n, cin, cout, h, w, wrow, ti, th, tw, tiles_h,
                  tiles_w, co_tiles, cs, sb, cps, splits, vec, cfg, flip,
                  smem_bytes, device, stream)
      t2v_conv3x3_wgrad(x, dy, dw, n, cin, cout, h, w, ti, th, tw, tiles_h,
                        tiles_w, nq, qps, cs, ci_tiles, splits, cfg, smem_bytes,
                        device, stream)
      t2v_conv3x3_reduce(part, splits, total, out, bias, hw, cout, device, stream)
    Pointers and the stream are c_void_p ("p"), ints c_int ("i"), the total
    c_longlong ("l")."""
    sig = {"t2v_conv3x3": "pppp" + "i" * 21 + "p",
           "t2v_conv3x3_wgrad": "ppp" + "i" * 18 + "p",
           "t2v_conv3x3_reduce": "pilppiiip"}[name]
    fn = getattr(_build.load("conv3x3"), name)
    fn.argtypes = [{"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}[x]
                   for x in sig]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(what, *tensors):
    """What the kernels take: float32 CUDA tensors of one device, 4-D, each
    under 2^31 elements (the kernels' int32 offsets)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} runs float32 on CUDA, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{what} takes 4-D tensors, got {tuple(t.shape)}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{what}: {tuple(t.shape)} is too large for int32 offsets")


def conv3x3_reduce(part, splits, out, bias, hw, cout):
    """out = the fixed-order sum of the `splits` partial results in part,
    plus bias[(i / hw) % cout] where bias is given."""
    err = _kernel("t2v_conv3x3_reduce")(
        part.data_ptr(), splits, out.numel(), out.data_ptr(),
        bias.data_ptr() if bias is not None else None, hw, cout, out.device.index,
        _stream(out))
    _raise_on(err, "conv3x3_reduce")
    conv3x3_reduce.launches += 1


def _conv(x, w, bias, cout, flip, op):
    """y (n, cout, h, w) from x (n, cin, h, w) and the stored weight w:
    (cout, cin, 3, 3), or (cin, cout, 3, 3) under flip; op is the calling
    wrapper, whose launches it counts."""
    what = op.__name__
    n, cin, h, wd = x.shape
    y = torch.empty((n, cout, h, wd), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    if y.numel() >= 2 ** 31:
        raise ValueError(f"{what}: the output {tuple(y.shape)} is too large for int32 offsets")
    plan = conv_plan(n, cin, cout, h, wd, flip, sm_count(x.device.index))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{what}: no tile of {h}x{wd} planes fits shared memory")
    wrow = TAPS * w.shape[1]
    vec = int(wrow % 4 == 0 and w.data_ptr() % 16 == 0)
    dst = y if plan.splits == 1 else torch.empty((plan.splits, n, cout, h, wd),
                                                 dtype=torch.float32, device=x.device)
    err = _kernel("t2v_conv3x3")(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        dst.data_ptr(), n, cin, cout, h, wd, wrow, plan.ti, plan.th, plan.tw, plan.tiles_h,
        plan.tiles_w, plan.co_tiles, plan.cs, plan.sb, plan.cps, plan.splits, vec, plan.cfg,
        int(flip), plan.smem_bytes, x.device.index, _stream(x))
    _raise_on(err, what)
    op.launches += 1
    if plan.splits > 1:
        conv3x3_reduce(dst, plan.splits, y, bias, h * wd, cout)
    return y


def conv3x3(x, w, bias=None):
    """y = conv(x, w) + bias: x (n, cin, h, w), w (cout, cin, 3, 3), bias
    (cout) or None. The kernel for CUDA tensors, F.conv2d for CPU ones."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias)
    _check("conv3x3", x, w)
    if w.shape[1] != x.shape[1] or w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3: weight {tuple(w.shape)} for input {tuple(x.shape)}")
    if bias is not None and (bias.device != x.device or bias.dtype != torch.float32
                             or tuple(bias.shape) != (w.shape[0],)):
        raise ValueError(f"conv3x3: bias {bias.dtype} {tuple(bias.shape)} on {bias.device} "
                         f"for {w.shape[0]} float32 output channels on {x.device}")
    return _conv(x.contiguous(), w.contiguous(), None if bias is None else bias.contiguous(),
                 w.shape[0], False, conv3x3)


def conv3x3_input_grad(dy, w):
    """dx (n, cin, h, w) from dy (n, cout, h, w) and w (cout, cin, 3, 3): the
    convolution of dy with w flipped and transposed."""
    if dy.device.type == "cpu":
        return conv3x3_input_grad_reference(dy, w)
    _check("conv3x3_input_grad", dy, w)
    if w.shape[0] != dy.shape[1] or w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3_input_grad: weight {tuple(w.shape)} for dy "
                         f"{tuple(dy.shape)}")
    return _conv(dy.contiguous(), w.contiguous(), None, w.shape[1], True, conv3x3_input_grad)


def conv3x3_weight_grad(x, dy):
    """dw (cout, cin, 3, 3) from x (n, cin, h, w) and dy (n, cout, h, w)."""
    if x.device.type == "cpu":
        return conv3x3_weight_grad_reference(x, dy)
    _check("conv3x3_weight_grad", x, dy)
    n, cin, h, wd = x.shape
    cout = dy.shape[1]
    if dy.shape[0] != n or dy.shape[2:] != x.shape[2:]:
        raise ValueError(f"conv3x3_weight_grad: x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or n * h * wd == 0:
        return dw.zero_()
    x, dy = x.contiguous(), dy.contiguous()
    plan = wgrad_plan(n, cin, cout, h, wd, sm_count(x.device.index))
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"conv3x3_weight_grad: no tile of {h}x{wd} planes fits shared memory")
    dst = dw if plan.splits == 1 else torch.empty((plan.splits, cout, cin, 3, 3),
                                                  dtype=torch.float32, device=x.device)
    err = _kernel("t2v_conv3x3_wgrad")(
        x.data_ptr(), dy.data_ptr(), dst.data_ptr(), n, cin, cout, h, wd, plan.ti, plan.th,
        plan.tw, plan.tiles_h, plan.tiles_w, plan.nq, plan.qps, plan.cs, plan.ci_tiles,
        plan.splits, plan.cfg, plan.smem_bytes, x.device.index, _stream(x))
    _raise_on(err, "conv3x3_weight_grad")
    conv3x3_weight_grad.launches += 1
    if plan.splits > 1:
        conv3x3_reduce(dst, plan.splits, dw, None, 1, 1)
    return dw


class Conv3x3(torch.autograd.Function):
    """y = conv(x, w) + b; the backward through Conv3x3InputGrad and
    Conv3x3WeightGrad."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return conv3x3(x, w, bias)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = Conv3x3InputGrad.apply(gy, w) if ctx.needs_input_grad[0] else None
        gw = Conv3x3WeightGrad.apply(x, gy) if ctx.needs_input_grad[1] else None
        gb = gy.sum((0, 2, 3)) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return gx, gw, gb


class Conv3x3InputGrad(torch.autograd.Function):
    """dx = conv_input(dy, w), linear in each: its backward is
    (Conv3x3(g, w), Conv3x3WeightGrad(g, dy))."""

    @staticmethod
    def forward(ctx, dy, w):
        ctx.save_for_backward(dy, w)
        return conv3x3_input_grad(dy, w)

    @staticmethod
    def backward(ctx, g):
        dy, w = ctx.saved_tensors
        gdy = Conv3x3.apply(g, w, None) if ctx.needs_input_grad[0] else None
        gw = Conv3x3WeightGrad.apply(g, dy) if ctx.needs_input_grad[1] else None
        return gdy, gw


class Conv3x3WeightGrad(torch.autograd.Function):
    """dw = conv_weight(x, dy), linear in each: its backward is
    (Conv3x3InputGrad(dy, g), Conv3x3(x, g))."""

    @staticmethod
    def forward(ctx, x, dy):
        ctx.save_for_backward(x, dy)
        return conv3x3_weight_grad(x, dy)

    @staticmethod
    def backward(ctx, g):
        x, dy = ctx.saved_tensors
        gx = Conv3x3InputGrad.apply(dy, g) if ctx.needs_input_grad[0] else None
        gdy = Conv3x3.apply(x, g, None) if ctx.needs_input_grad[1] else None
        return gx, gdy


for _wrapper in (conv3x3, conv3x3_input_grad, conv3x3_weight_grad, conv3x3_reduce):
    _wrapper.launches = 0
