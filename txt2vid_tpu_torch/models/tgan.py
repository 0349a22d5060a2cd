"""TGAN generator family (counterpart of txt2vid_tpu/models/tgan.py).

FrameSeedGenerator: a 1-D transposed-convolution stack expanding one latent
into exactly 16 per-frame latents, Tanh output. VideoFrameGenerator: a
per-frame 2-D transposed-convolution decoder, 4x4 -> 64x64, from
[h_slow ‖ h_fast]. Gen: cond concatenated into z_slow, z_slow tiled across
the 16 frames, time folded into the batch for the frame decoder. Discrim is
the TCWYT video discriminator (models/tcwyt.py).

Inputs and outputs are in the JAX layout (videos (B, T, H, W, C), the seeds
(B, 16, z_fast)); inside, channels come first. `dtype` is flax's compute
dtype (models/layers.py): parameters float32, per-use casts, BatchNorm's
statistics in float32.
"""

import torch
from torch import nn

from txt2vid_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d, ConvTranspose1d,
                                             ConvTranspose2d, Linear, init_kernels)


def check_mode(module, train):
    """A forward's `train` must agree with the module's train/eval mode,
    which is what BatchNorm reads."""
    if train is not None and train != module.training:
        raise ValueError(f"forward(train={train}) on a module in "
                         f"{'training' if module.training else 'eval'} mode")


class FrameSeedGenerator(nn.Module):
    """(B, in_dim) -> (B, 16, z_fast_dim)."""

    def __init__(self, in_dim: int, z_fast_dim: int = 256, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.dc0 = ConvTranspose1d(in_dim, 512, 1, padding="VALID", compute_dtype=dtype)
        self.bn0 = BatchNorm1d(512, eps=1e-5, compute_dtype=dtype)
        chans = (512, 256, 128, 128)
        for i in range(3):
            self.add_module(f"dc{i + 1}", ConvTranspose1d(chans[i], chans[i + 1], 4, stride=2,
                                                          compute_dtype=dtype))
            self.add_module(f"bn{i + 1}", BatchNorm1d(chans[i + 1], eps=1e-5,
                                                      compute_dtype=dtype))
        self.dc4 = ConvTranspose1d(128, z_fast_dim, 4, stride=2, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, z_slow):
        h = z_slow[:, :, None]                               # (B, C, L=1)
        if self.dtype is not None:
            h = h.to(self.dtype)
        for i in range(4):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dc{i}")(h)))
        return torch.tanh(self.dc4(h)).transpose(1, 2)       # (B, 16, z_fast)


class VideoFrameGenerator(nn.Module):
    """(N, slow_dim), (N, fast_dim) -> (N, 64, 64, out_channels)."""

    def __init__(self, slow_dim: int, fast_dim: int, out_channels: int = 3,
                 bottom_width: int = 4, conv_ch: int = 512, dtype=None):
        super().__init__()
        self.dtype, self.bottom_width, self.conv_ch = dtype, bottom_width, conv_ch
        mid = bottom_width * bottom_width * conv_ch // 2
        self.l0s = Linear(slow_dim, mid, compute_dtype=dtype)
        self.bn0s = BatchNorm1d(mid, eps=1e-5, compute_dtype=dtype)
        self.l0f = Linear(fast_dim, mid, compute_dtype=dtype)
        self.bn0f = BatchNorm1d(mid, eps=1e-5, compute_dtype=dtype)
        chans = (conv_ch, conv_ch // 2, conv_ch // 4, conv_ch // 8, conv_ch // 16)
        for i in range(4):
            self.add_module(f"dc{i + 1}", ConvTranspose2d(chans[i], chans[i + 1], 4, stride=2,
                                                          compute_dtype=dtype))
            self.add_module(f"bn{i + 1}", BatchNorm2d(chans[i + 1], eps=1e-5,
                                                      compute_dtype=dtype))
        self.dc5 = ConvTranspose2d(chans[-1], out_channels, 3, stride=1, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, z_slow, z_fast):
        n, bw, half = z_slow.shape[0], self.bottom_width, self.conv_ch // 2
        if self.dtype is not None:
            z_slow, z_fast = z_slow.to(self.dtype), z_fast.to(self.dtype)
        hs = torch.relu(self.bn0s(self.l0s(z_slow)))
        hf = torch.relu(self.bn0f(self.l0f(z_fast)))
        # flax reshapes each half to (n, bw, bw, C/2): NCHW after
        h = torch.cat([hs.reshape(n, bw, bw, half).permute(0, 3, 1, 2),
                       hf.reshape(n, bw, bw, half).permute(0, 3, 1, 2)], dim=1)
        for i in range(1, 5):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dc{i}")(h)))
        return torch.tanh(self.dc5(h)).permute(0, 2, 3, 1)


class Gen(nn.Module):
    """(B, z_slow_dim) [, cond (B, cond_dim)] -> (B, 16, 64, 64, out_channels)."""

    def __init__(self, z_slow_dim: int = 256, z_fast_dim: int = 256, cond_dim: int = 0,
                 out_channels: int = 3, bottom_width: int = 4, conv_ch: int = 512, dtype=None):
        super().__init__()
        self.latent_size = z_slow_dim
        self.dtype = dtype
        self.fsgen = FrameSeedGenerator(z_slow_dim + cond_dim, z_fast_dim, dtype=dtype)
        self.vgen = VideoFrameGenerator(z_slow_dim + cond_dim, z_fast_dim, out_channels,
                                        bottom_width, conv_ch, dtype=dtype)

    def forward(self, z, cond=None, train: bool | None = None):
        check_mode(self, train)
        z_slow = z if cond is None else torch.cat([z, cond], dim=-1)
        z_fast = self.fsgen(z_slow)                           # (B, 16, zf)
        b, n_frames = z_fast.shape[:2]
        frames = self.vgen(z_slow.repeat_interleave(n_frames, dim=0),
                           z_fast.reshape(b * n_frames, -1))
        return frames.reshape(b, n_frames, *frames.shape[1:])


def Discrim(**kwargs):
    """The TCWYT video discriminator (tgan.py:120-123)."""
    from txt2vid_tpu_torch.models.tcwyt import VideoDiscrim
    return VideoDiscrim(**kwargs)
