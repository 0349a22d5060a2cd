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
"""

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from txt2vid_tpu_torch.ops.attention import attention_core_auto, kernel_disabled, kernels_disabled
from txt2vid_tpu_torch.ops.initializers import RESIDUAL_GAIN, kernel_init_
from txt2vid_tpu_torch.ops.pooling import (avg_pool_3d_shape_aware, max_pool_2d,
                                           max_pool_3d, upsample_nearest_2d)

# flax BatchNorm(momentum=0.9): running = 0.9 * running + 0.1 * batch statistic
_FLAX_MOMENTUM = 0.9
# set while remat recomputes a block's forward for its backward
_RECOMPUTING = contextvars.ContextVar("txt2vid_remat_recomputing", default=False)


class _recompute_context:
    """Entered for each recomputation of one remat block (a block under the
    gradient penalty's double backward is recomputed once per backward)."""

    def __init__(self, kernels_off: bool):
        self.kernels_off = kernels_off
        self._entered = []

    def __enter__(self):
        kernels = kernel_disabled(self.kernels_off)
        kernels.__enter__()
        self._entered.append((_RECOMPUTING.set(True), kernels))

    def __exit__(self, *exc):
        token, kernels = self._entered.pop()
        _RECOMPUTING.reset(token)
        return kernels.__exit__(*exc)


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward instead of kept
    (flax's nn.remat, the `remat` field of MultiScaleGen and MultiScaleDiscrim):
    non-reentrant torch.utils.checkpoint, so the double backward of the
    gradient penalty goes through it. The recomputation sees what the forward
    saw and changes nothing the forward did: it takes the attention path the
    forward took (no_kernel() or not, captured at the forward), and BatchNorm
    leaves its running statistics alone, which the forward updated once, as
    flax's remat does. The wrapped blocks draw no random numbers; the RNG
    state is restored for the recomputation all the same."""
    kernels_off = kernels_disabled()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recompute_context(kernels_off)))


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


class Conv2d(_Casting, nn.Conv2d):
    def _apply_cast(self, x, weight, bias):
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


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's training semantics (layers.py:107-108), under
    torch's state-dict names. Training mode normalises with the batch mean and
    the biased batch variance and updates the running statistics as
    0.9 * old + 0.1 * batch, the variance biased too (torch's own update uses
    momentum 0.1 and the unbiased variance). Eval mode uses the running
    statistics. The recomputation of a remat block (see `remat`) normalises
    the same way and leaves the statistics alone.

    Every dtype takes one path, flax's BatchNorm(dtype), never F.batch_norm's
    mixed-type kernels, which differ by backend: input, scale and bias cast to
    float32, the statistics and the normalisation taken there, the result
    cast to `compute_dtype` (or the common type of input and parameters, so a
    float32 module in float32 is plain batch norm); the running statistics
    stay float32."""

    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _update_stats(self, mean, var):
        if not _RECOMPUTING.get():      # remat's recomputation updates nothing
            with torch.no_grad():
                self.running_mean.mul_(_FLAX_MOMENTUM).add_(mean, alpha=1 - _FLAX_MOMENTUM)
                self.running_var.mul_(_FLAX_MOMENTUM).add_(var, alpha=1 - _FLAX_MOMENTUM)

    def forward(self, x):
        out = self.compute_dtype or torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        x32, weight, bias = promote(torch.promote_types(x.dtype, torch.float32),
                                    x, self.weight, self.bias)
        if self.training:
            self._update_stats(*reversed(torch.var_mean(x32.detach(), dim=(0, 2, 3),
                                                        correction=0)))
            y = F.batch_norm(x32, None, None, weight, bias, True, 0.0, self.eps)
        else:
            y = F.batch_norm(x32, self.running_mean, self.running_var, weight, bias, False,
                             0.0, self.eps)
        return y.to(out)

    def init_weights(self, generator):
        self.reset_parameters()     # weight 1, bias 0, running mean 0 / var 1


def _tokens(x):
    """(B, C, *spatial) -> contiguous (B, prod(spatial), C), rows in the JAX
    reshape order ((h, w) or (t, h, w))."""
    return x.movedim(1, -1).reshape(x.shape[0], -1, x.shape[1]).contiguous()


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
        o = o.reshape(b, h, w, -1).permute(0, 3, 1, 2)
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
        o = o.reshape(b, t, h, w, -1).permute(0, 4, 1, 2, 3)
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
