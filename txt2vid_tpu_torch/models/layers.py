"""Building blocks (counterpart of txt2vid_tpu/models/layers.py): NCHW for the
generator's 2-D blocks, NCDHW for the discriminator's 3-D ones.

The non-local `Attention` / `Attention3d` route their softmax core through the
fused CUDA kernels for CUDA tensors (ops/attention.py) and their plain versions
for CPU tensors. Module and parameter names follow the JAX package, so
txt2vid_tpu_torch.convert maps a flax tree onto these state dicts by name.

`dtype` is flax's: parameters stay float32, and each use casts. A convolution
or dense layer casts its input, weight and bias to `dtype` (bf16 in, bf16
out; cuDNN and oneDNN accumulate in float32); with dtype None they are
promoted to their common type, so a bf16 weight copy under a float32 input
computes in float32 (`promote`, flax's promote_dtype). BatchNorm takes its
statistics and normalises in float32 and returns `dtype`.

A float32 3x3 Conv2d (stride 1, padding 1, no dilation or groups, at least
8 output channels) on a CUDA tensor runs on the tensor-core convolution
kernels (ops/conv.py), its gradients too; `takes_conv_kernel` is the rule,
and ops.attention.no_kernel() sends it back to F.conv2d.

The TCWYT, TGAN and image-GAN families (models/tcwyt.py, tgan.py, img.py)
add flax's transposed convolution (`ConvTranspose1d/2d/3d`), convolutions
padded as flax's SAME pads (`SameConv2d/3d`, `same_pad`), BatchNorm over
1-D and 3-D features and the image critic's LayerNorm over (C, H, W).
"""

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from txt2vid_tpu_torch.ops import batch_group
from txt2vid_tpu_torch.ops.attention import attention_core_auto, kernels_disabled
from txt2vid_tpu_torch.ops.conv import Conv3x3
from txt2vid_tpu_torch.ops.initializers import RESIDUAL_GAIN, kernel_init_
from txt2vid_tpu_torch.ops.pooling import (avg_pool_3d_shape_aware, max_pool_2d,
                                           max_pool_3d, upsample_nearest_2d)

# flax BatchNorm(momentum=0.9): running = 0.9 * running + 0.1 * batch statistic
_FLAX_MOMENTUM = 0.9
# set while BatchNorm must leave its running statistics alone: remat's
# recomputation of a block's forward, and the forwards whose statistics the
# JAX step discards (`frozen_batch_stats`)
_STATS_FROZEN = contextvars.ContextVar("txt2vid_batch_stats_frozen", default=False)


class _recompute_context:
    """Entered for each recomputation of one remat block (a block under the
    gradient penalty's double backward is recomputed once per backward): every
    context variable takes the value it had at the block's forward, and
    BatchNorm's statistics are frozen. The backward may run on another thread
    than the forward (on CUDA the autograd engine's device thread), whose
    context holds none of the forward's: the attention path (no_kernel()),
    the data-parallel group of BatchNorm's statistics (ops/batch_group.py) and
    the sequence-parallel ring (ops.attention.sequence_parallel)."""

    def __init__(self, forward_context: contextvars.Context):
        self.forward_context = forward_context
        self._entered = []

    def __enter__(self):
        tokens = [var.set(value) for var, value in self.forward_context.items()]
        self._entered.append(tokens + [_STATS_FROZEN.set(True)])

    def __exit__(self, *exc):
        for token in reversed(self._entered.pop()):
            token.var.reset(token)


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward instead of kept
    (flax's nn.remat, the `remat` field of MultiScaleGen and MultiScaleDiscrim):
    non-reentrant torch.utils.checkpoint, so the double backward of the
    gradient penalty goes through it. The recomputation sees what the forward
    saw and changes nothing the forward did: it runs in the forward's context
    (captured at the forward, whatever thread the backward runs on), so it
    takes the attention path the forward took, no_kernel() or not, the ring
    or not, and BatchNorm's statistics over the same group; and BatchNorm
    leaves its running statistics alone, which the forward updated once, as
    flax's remat does. The wrapped blocks draw no random numbers; the RNG
    state is restored for the recomputation all the same."""
    forward_context = contextvars.copy_context()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute_context(forward_context)))


@contextlib.contextmanager
def frozen_batch_stats():
    """Inside, train-mode BatchNorm normalises with the batch's statistics and
    leaves its running statistics as they are. The JAX package applies every
    discriminator and the sample mapping with mutable=["batch_stats"] and
    throws the update away (cond_gan.py:82-107): their running statistics
    keep their init values, and gan/cond_gan.py runs their forwards in here."""
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


def promote(dtype, *tensors):
    """flax's promote_dtype: each tensor (None stays None) cast to `dtype`, or,
    when it is None, to the tensors' common type."""
    if dtype is None:
        dtype = functools.reduce(torch.promote_types,
                                 [t.dtype for t in tensors if t is not None])
    return [None if t is None else t.to(dtype) for t in tensors]


class _Casting:
    """A convolution or linear layer with flax's per-use cast (`promote`) to
    `compute_dtype`; parameters keep their own dtype."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        x, weight, bias = promote(self.compute_dtype, x, self.weight, self.bias)
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            # the CPU backend's bf16 Conv3d returns non-finite values for a
            # one-frame input; computing from the bf16 values in float32 and
            # rounding once is what a bf16 product accumulated in float32
            # gives (cuDNN's on the card)
            return self._apply_cast(x.float(), weight.float(),
                                    None if bias is None else bias.float()).to(x.dtype)
        return self._apply_cast(x, weight, bias)


# the least output channels a Conv2d takes the convolution kernels with: the
# render blocks' C_out = 1 (and 3) convolutions stay on F.conv2d
CONV_KERNEL_MIN_OUT = 8


def takes_conv_kernel(conv, device_type: str, dtype) -> bool:
    """Whether Conv2d `conv` sends an input of `dtype` (after `promote`) on
    a `device_type` device to the convolution kernels (ops/conv.py): on
    CUDA, float32, 3x3, stride 1, padding 1 (zeros), dilation 1, groups 1,
    at least CONV_KERNEL_MIN_OUT output channels, outside no_kernel()."""
    return (device_type == "cuda" and dtype == torch.float32 and conv.kernel_size == (3, 3)
            and conv.stride == (1, 1) and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1 and conv.padding_mode == "zeros"
            and conv.out_channels >= CONV_KERNEL_MIN_OUT and not kernels_disabled())


class Conv2d(_Casting, nn.Conv2d):
    def _apply_cast(self, x, weight, bias):
        if takes_conv_kernel(self, x.device.type, x.dtype):
            return Conv3x3.apply(x, weight, bias)
        return self._conv_forward(x, weight, bias)


class Conv3d(_Casting, nn.Conv3d):
    def _apply_cast(self, x, weight, bias):
        return self._conv_forward(x, weight, bias)


class Linear(_Casting, nn.Linear):
    def _apply_cast(self, x, weight, bias):
        return F.linear(x, weight, bias)


def _init_conv(conv, generator, gain: float = 1.0):
    kernel_init_(conv.weight, gain, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class _FlaxBatchNorm:
    """BatchNorm with flax's training semantics (layers.py:107-108), under
    torch's state-dict names, over the channel axis 1 of (B, C), (B, C, L),
    (B, C, H, W) or (B, C, T, H, W). Training mode normalises with the batch
    mean and the biased batch variance, over every axis but 1, and updates
    the running statistics as 0.9 * old + 0.1 * batch, the variance biased
    too (torch's own update uses momentum 0.1 and the unbiased variance).
    Eval mode uses the running statistics. The recomputation of a remat block
    (see `remat`) and the forwards under `frozen_batch_stats` normalise the
    same way and leave the statistics alone.

    Every dtype takes one path, flax's BatchNorm(dtype), never F.batch_norm's
    mixed-type kernels, which differ by backend: input, scale and bias cast to
    float32, the statistics and the normalisation taken there, the result
    cast to `compute_dtype` (or the common type of input and parameters, so a
    float32 module in float32 is plain batch norm); the running statistics
    stay float32.

    In a train step whose batch is split over data-parallel ranks
    (ops/batch_group.py) training mode takes the global batch's statistics:
    the ranks' counts, sums and sums of squares summed through an autograd
    collective, the variance E[x^2] - E[x]^2 floored at 0 as flax's
    BatchNorm forms it, and the running statistics move by those."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _update_stats(self, mean, var):
        if not _STATS_FROZEN.get():
            with torch.no_grad():
                self.running_mean.mul_(_FLAX_MOMENTUM).add_(mean, alpha=1 - _FLAX_MOMENTUM)
                self.running_var.mul_(_FLAX_MOMENTUM).add_(var, alpha=1 - _FLAX_MOMENTUM)

    def forward(self, x):
        out = self.compute_dtype or torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        x32, weight, bias = promote(torch.promote_types(x.dtype, torch.float32),
                                    x, self.weight, self.bias)
        group = batch_group.group()
        if self.training and group is not None:
            dims = (0, *range(2, x.dim()))
            mean, var = group.batch_stats(x32, dims)
            self._update_stats(mean.detach(), var.detach())
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = ((x32 - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
                 * weight.reshape(shape) + bias.reshape(shape))
        elif self.training:
            dims = (0, *range(2, x.dim()))
            self._update_stats(*reversed(torch.var_mean(x32.detach(), dim=dims,
                                                        correction=0)))
            y = F.batch_norm(x32, None, None, weight, bias, True, 0.0, self.eps)
        else:
            y = F.batch_norm(x32, self.running_mean, self.running_var, weight, bias, False,
                             0.0, self.eps)
        return y.to(out)

    def init_weights(self, generator):
        self.reset_parameters()     # weight 1, bias 0, running mean 0 / var 1


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """Over (B, C) or (B, C, L)."""


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """Over (B, C, H, W)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """Over (B, C, T, H, W)."""


def same_pad(x, kernel, strides):
    """Pad an (N, C, *spatial) tensor as flax's padding="SAME" does: each
    axis to out = ceil(size / stride), the odd element after (with stride 2
    and an even kernel on an odd size, or an odd total). A symmetric torch
    padding would sample windows shifted by a pixel there."""
    pads = []
    for size, k, s in zip(x.shape[2:], kernel, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    if not any(p for lo_hi in pads for p in lo_hi):
        return x
    return F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])


class SameConv2d(Conv2d):
    """Conv2d with flax's SAME padding (no padding of its own) and its cast."""

    def _apply_cast(self, x, weight, bias):
        return self._conv_forward(same_pad(x, self.kernel_size, self.stride), weight, bias)


class SameConv3d(Conv3d):
    """Conv3d with flax's SAME padding (no padding of its own) and its cast."""

    def _apply_cast(self, x, weight, bias):
        return self._conv_forward(same_pad(x, self.kernel_size, self.stride), weight, bias)


def transpose_padding(k: int, s: int, padding: str):
    """(before, after) padding of the stride-dilated input that flax's
    ConvTranspose (jax.lax.conv_transpose) gives one axis, for a kernel k,
    stride s and padding "SAME" or "VALID"."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding {padding!r}: SAME or VALID")
    return pad_a, pad_len - pad_a


class _ConvTranspose(_Casting):
    """flax's nn.ConvTranspose (transpose_kernel=False), in torch's layout.

    flax convolves the stride-dilated input, padded by `transpose_padding`,
    with its kernel (*k, in, out) as it is; torch's transposed convolution
    correlates with the kernel flipped. The torch weight (in, out, *k) is
    therefore the flax kernel flipped along its spatial axes and permuted
    (convert.py does it), and the padding is torch's
    padding = k - 1 - before, output_padding = after - before."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding="SAME",
                 bias=True, compute_dtype=None):
        n = self._ndim
        ks = (kernel_size,) * n if isinstance(kernel_size, int) else tuple(kernel_size)
        st = (stride,) * n if isinstance(stride, int) else tuple(stride)
        pads = [transpose_padding(k, s, padding) for k, s in zip(ks, st)]
        super().__init__(in_channels, out_channels, ks, stride=st,
                         padding=tuple(k - 1 - a for k, (a, _) in zip(ks, pads)),
                         output_padding=tuple(b - a for a, b in pads), bias=bias,
                         compute_dtype=compute_dtype)

    def _apply_cast(self, x, weight, bias):
        return self._conv(x, weight, bias, self.stride, self.padding, self.output_padding)


class ConvTranspose1d(_ConvTranspose, nn.ConvTranspose1d):
    _ndim, _conv = 1, staticmethod(F.conv_transpose1d)


class ConvTranspose2d(_ConvTranspose, nn.ConvTranspose2d):
    _ndim, _conv = 2, staticmethod(F.conv_transpose2d)


class ConvTranspose3d(_ConvTranspose, nn.ConvTranspose3d):
    _ndim, _conv = 3, staticmethod(F.conv_transpose3d)


class LayerNormCHW(nn.Module):
    """flax's nn.LayerNorm(reduction_axes=feature_axes=(-3, -2, -1),
    epsilon=1e-5) over an NHWC input, here over (C, H, W) of an NCHW one:
    one mean and variance per sample, scale and bias of shape (C, H, W)
    (convert.py transposes flax's (H, W, C)). The statistics are flax's fast
    ones, E[x^2] - E[x]^2 clipped at 0, in float32; the result has
    `compute_dtype` (or the common type of input and parameters)."""

    def __init__(self, shape, eps: float = 1e-5, compute_dtype=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))

    def init_weights(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        out = self.compute_dtype or torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = tuple(range(1, x.dim()))
        mean = x32.mean(dims, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dims, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(out)


def init_kernels(module, generator, gain: float = 1.0):
    """The JAX package's init of each of `module`'s own convolutions and
    dense layers (its direct children; submodules with an `init_weights` of
    their own init themselves): the active kernel init times `gain`, zero
    biases."""
    for child in module.children():
        if isinstance(child, (nn.Linear, nn.modules.conv._ConvNd)):
            _init_conv(child, generator, gain)


def _tokens(x):
    """(B, C, *spatial) -> contiguous (B, prod(spatial), C), rows in the JAX
    reshape order ((h, w) or (t, h, w))."""
    return x.movedim(1, -1).flatten(1, -2).contiguous()


class Attention(nn.Module):
    """2D non-local block, SA-GAN/BigGAN style: theta/phi C/8 channels, g C/2,
    2x2 max-pool on phi/g, unscaled softmax over H*W x H*W/4, output 1x1 conv,
    learnable scalar gamma (init 0), residual. Input (B, C, H, W). With dtype
    bf16 the projections run in bf16, so the attention core takes bf16
    theta, phi and g (K1-K3's bf16 instantiations on CUDA)."""

    def __init__(self, ch: int, use_kernel: bool = True, dtype=None):
        super().__init__()
        self.use_kernel = use_kernel
        self.theta = Conv2d(ch, ch // 8, 1, bias=False, compute_dtype=dtype)
        self.phi = Conv2d(ch, ch // 8, 1, bias=False, compute_dtype=dtype)
        self.g = Conv2d(ch, ch // 2, 1, bias=False, compute_dtype=dtype)
        self.o = Conv2d(ch // 2, ch, 1, bias=False, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def init_weights(self, generator):
        for conv in (self.theta, self.phi, self.g, self.o):
            _init_conv(conv, generator)
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        b, _, h, w = x.shape
        o = attention_core_auto(_tokens(self.theta(x)),
                                _tokens(max_pool_2d(self.phi(x))),
                                _tokens(max_pool_2d(self.g(x))),
                                use_kernel=self.use_kernel)          # (B, N, C/2)
        o = o.reshape(b, h, w, o.shape[-1]).permute(0, 3, 1, 2)
        return self.gamma.to(x.dtype) * self.o(o) + x


class Attention3d(nn.Module):
    """Video non-local block (layers.py:55-85): Attention with Conv3d
    projections, a [1, 2, 2] max-pool on phi/g and attention over T*H*W x
    T*H*W/4, tokens in (t, h, w) order. Input (B, C, T, H, W)."""

    def __init__(self, ch: int, use_kernel: bool = True, dtype=None):
        super().__init__()
        self.use_kernel = use_kernel
        self.theta = Conv3d(ch, ch // 8, 1, bias=False, compute_dtype=dtype)
        self.phi = Conv3d(ch, ch // 8, 1, bias=False, compute_dtype=dtype)
        self.g = Conv3d(ch, ch // 2, 1, bias=False, compute_dtype=dtype)
        self.o = Conv3d(ch // 2, ch, 1, bias=False, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def init_weights(self, generator):
        for conv in (self.theta, self.phi, self.g, self.o):
            _init_conv(conv, generator)
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        b, _, t, h, w = x.shape
        o = attention_core_auto(_tokens(self.theta(x)),
                                _tokens(max_pool_3d(self.phi(x))),
                                _tokens(max_pool_3d(self.g(x))),
                                use_kernel=self.use_kernel)          # (B, N, C/2)
        o = o.reshape(b, t, h, w, o.shape[-1]).permute(0, 4, 1, 2, 3)
        return self.gamma.to(x.dtype) * self.o(o) + x


class UpBlock(nn.Module):
    """Pre-activation residual 2x-upsample block: main = BN-ReLU-Upsample-
    conv3x3-BN-ReLU-conv3x3 (sqrt(2)-gain init), identity = Upsample (+1x1 conv
    on channel change); optional trailing Attention."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 with_non_local: bool = False, use_kernel: bool = True, dtype=None):
        super().__init__()
        out_ch = out_channels if out_channels is not None else in_channels
        self.bn1 = BatchNorm2d(in_channels, eps=1e-5, compute_dtype=dtype)
        self.conv1 = Conv2d(in_channels, out_ch, 3, padding=1, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(out_ch, eps=1e-5, compute_dtype=dtype)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, compute_dtype=dtype)
        self.conv_identity = (Conv2d(in_channels, out_ch, 1, compute_dtype=dtype)
                              if in_channels != out_ch else None)
        self.attn = Attention(out_ch, use_kernel, dtype) if with_non_local else None

    def init_weights(self, generator):
        _init_conv(self.conv1, generator, RESIDUAL_GAIN)
        _init_conv(self.conv2, generator, RESIDUAL_GAIN)
        if self.conv_identity is not None:
            _init_conv(self.conv_identity, generator)

    def forward(self, x):
        h = torch.relu(self.bn1(x))
        h = self.conv1(upsample_nearest_2d(h))
        h = self.conv2(torch.relu(self.bn2(h)))
        identity = upsample_nearest_2d(x)
        if self.conv_identity is not None:
            identity = self.conv_identity(identity)
        h = identity + h
        if self.attn is not None:
            h = self.attn(h)
        return h


class DownBlock(nn.Module):
    """Residual 3D down block (layers.py:140-168): main = ReLU-conv3-ReLU-conv3
    (sqrt(2)-gain init) then the shape-aware average pool, identity = 1x1 conv
    then the same pool. The middle width is out_channels when `wide`, else
    in_channels. Input (B, C, T, H, W)."""

    def __init__(self, in_channels: int, out_channels: int | None = None,
                 wide: bool = True, dtype=None):
        super().__init__()
        out_ch = out_channels if out_channels is not None else in_channels
        mid_ch = out_ch if wide else in_channels
        self.conv1 = Conv3d(in_channels, mid_ch, 3, padding=1, compute_dtype=dtype)
        self.conv2 = Conv3d(mid_ch, out_ch, 3, padding=1, compute_dtype=dtype)
        self.conv_identity = Conv3d(in_channels, out_ch, 1, compute_dtype=dtype)

    def init_weights(self, generator):
        _init_conv(self.conv1, generator, RESIDUAL_GAIN)
        _init_conv(self.conv2, generator, RESIDUAL_GAIN)
        _init_conv(self.conv_identity, generator)

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        identity = self.conv_identity(x)
        return avg_pool_3d_shape_aware(identity) + avg_pool_3d_shape_aware(h)


class RenderBlock(nn.Module):
    """BN-ReLU-conv3x3-Tanh to RGB."""

    def __init__(self, in_channels: int, out_channels: int = 3, dtype=None):
        super().__init__()
        self.bn = BatchNorm2d(in_channels, eps=1e-5, compute_dtype=dtype)
        self.conv = Conv2d(in_channels, out_channels, 3, padding=1, compute_dtype=dtype)

    def init_weights(self, generator):
        _init_conv(self.conv, generator)

    def forward(self, x):
        return torch.tanh(self.conv(torch.relu(self.bn(x))))
