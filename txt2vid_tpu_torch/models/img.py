"""Frame-level WGAN-GP ResNet image GAN (counterpart of
txt2vid_tpu/models/img.py): scripts/run_tgan.sh's pair and the CIFAR-10
path.

Up blocks: BN-ReLU-(nearest-up + conv3)-BN-ReLU-conv3, shortcut nearest-up +
conv1. Down blocks: LN-ReLU-conv3-LN-ReLU-(conv3 + 2x2 mean pool), shortcut
mean pool + conv1; the LayerNorm normalises over (C, H, W) of each sample
(layers.LayerNormCHW). Images are (B, H, W, C) at the boundaries, NCHW
inside. The critic takes 64-px images (its last Dense reads a 4x4 map, as
the JAX module's reshape does) and runs that Dense in float32. `dtype` as
in models/layers.py.
"""

import torch
from torch import nn

from txt2vid_tpu_torch.models.layers import (BatchNorm2d, Conv2d, LayerNormCHW, Linear,
                                             init_kernels)
from txt2vid_tpu_torch.models.tgan import check_mode
from txt2vid_tpu_torch.ops.pooling import upsample_nearest_2d


def _mean_pool(x):
    """(B, C, H, W) 2x2 mean, summed x00 + x10 + x01 + x11 then divided by 4
    as img.py:20-21 does."""
    return (x[:, :, ::2, ::2] + x[:, :, 1::2, ::2] + x[:, :, ::2, 1::2]
            + x[:, :, 1::2, 1::2]) / 4.0


class ResidualBlockUp(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, dtype=None):
        super().__init__()
        self.conv_shortcut = Conv2d(in_dim, out_dim, 1, compute_dtype=dtype)
        self.bn1 = BatchNorm2d(in_dim, eps=1e-5, compute_dtype=dtype)
        self.conv1 = Conv2d(in_dim, out_dim, 3, padding=1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm2d(out_dim, eps=1e-5, compute_dtype=dtype)
        self.conv2 = Conv2d(out_dim, out_dim, 3, padding=1, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, x):
        shortcut = self.conv_shortcut(upsample_nearest_2d(x))
        h = self.conv1(upsample_nearest_2d(torch.relu(self.bn1(x))))
        h = self.conv2(torch.relu(self.bn2(h)))
        return shortcut + h


class ResidualBlockDown(nn.Module):
    """(B, in_dim, size, size) -> (B, out_dim, size / 2, size / 2)."""

    def __init__(self, in_dim: int, out_dim: int, size: int, dtype=None):
        super().__init__()
        self.conv_shortcut = Conv2d(in_dim, out_dim, 1, compute_dtype=dtype)
        self.ln1 = LayerNormCHW((in_dim, size, size), compute_dtype=dtype)
        self.conv1 = Conv2d(in_dim, in_dim, 3, padding=1, bias=False, compute_dtype=dtype)
        self.ln2 = LayerNormCHW((in_dim, size, size), compute_dtype=dtype)
        self.conv2 = Conv2d(in_dim, out_dim, 3, padding=1, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, x):
        shortcut = self.conv_shortcut(_mean_pool(x))
        h = self.conv1(torch.relu(self.ln1(x)))
        h = self.conv2(torch.relu(self.ln2(h)))
        return shortcut + _mean_pool(h)


class Gen(nn.Module):
    """z (B, 128) -> (B, 64, 64, 3); cond is ignored, as in the JAX module."""

    latent_size = 128

    def __init__(self, cond_dim: int = 0, dim: int = 64, dtype=None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        d = dim
        self.ln1 = Linear(128, 4 * 4 * 8 * d, compute_dtype=dtype)
        chans = (8 * d, 8 * d, 4 * d, 2 * d, d)
        for i in range(4):
            self.add_module(f"rb{i + 1}", ResidualBlockUp(chans[i], chans[i + 1], dtype))
        self.bn = BatchNorm2d(d, eps=1e-5, compute_dtype=dtype)
        self.conv1 = Conv2d(d, 3, 3, padding=1, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, z, cond=None, train: bool | None = None):
        check_mode(self, train)
        if self.dtype is not None:
            z = z.to(self.dtype)
        h = self.ln1(z).reshape(-1, 4, 4, 8 * self.dim).permute(0, 3, 1, 2)
        for i in range(1, 5):
            h = getattr(self, f"rb{i}")(h)
        h = self.conv1(torch.relu(self.bn(h)))
        return torch.tanh(h).permute(0, 2, 3, 1)


class Discrim(nn.Module):
    """x (B, 64, 64, num_channels) -> (B,) float32 logits; cond and xbar are
    ignored. num_channels (3, the reference's) is the port's: flax infers it
    from the input."""

    def __init__(self, cond_dim: int = 256, dim: int = 64, num_channels: int = 3, dtype=None):
        super().__init__()
        self.dim, self.dtype = dim, dtype
        d = dim
        self.conv1 = Conv2d(num_channels, d, 3, padding=1, compute_dtype=dtype)
        chans, size = (d, 2 * d, 4 * d, 8 * d, 8 * d), 64
        for i in range(4):
            self.add_module(f"rb{i + 1}", ResidualBlockDown(chans[i], chans[i + 1], size, dtype))
            size //= 2
        self.ln1 = Linear(4 * 4 * 8 * d, 1)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, x=None, cond=None, xbar=None):
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = self.conv1(x.permute(0, 3, 1, 2))
        for i in range(1, 5):
            h = getattr(self, f"rb{i}")(h)
        h = h.permute(0, 2, 3, 1).reshape(-1, 4 * 4 * 8 * self.dim).float()
        return self.ln1(h)[:, 0]
