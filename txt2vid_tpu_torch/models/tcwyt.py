"""TCWYT ("To Create What You Tell") family (counterpart of
txt2vid_tpu/models/tcwyt.py).

Gen: [z ‖ cond] -> MLP -> five 3-D transposed convolutions -> (B, 16, 48,
48, C). VideoDiscrim: a 4-layer Conv3d pyramid and a prediction head over
the tiled cond (with cond_dim > 0) or without it, -> per-sample logits (B,).
FrameMap: the `--M` sample mapping, a shared per-frame 2-D pyramid ->
(B, T, H', W', 512). FrameDiscrim and MotionDiscrim read only that mapping
(`xbar`): per-frame logits (B, T), and over its temporal differences
(B, T - 1).

The per-frame modules fold T into the batch, so their BatchNorm takes its
statistics over B*T jointly: the JAX package's documented deviation from
the reference (tcwyt.py:11-15), followed here. Inputs and outputs are in the
JAX layout; inside, channels come first. Convolutions pad as flax's SAME
does (layers.same_pad: at stride 2 on an odd size the odd element goes
after). `dtype` as in models/layers.py; the logits are float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from txt2vid_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d, BatchNorm3d, Conv2d,
                                             Conv3d, ConvTranspose3d, Linear, SameConv2d,
                                             SameConv3d, init_kernels)
from txt2vid_tpu_torch.models.tgan import check_mode


def _lrelu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def _bn(cls, n, dtype):
    return cls(n, eps=1e-5, compute_dtype=dtype)


class Gen(nn.Module):
    """[z ‖ cond] -> (B, 16, 48, 48, num_channels)."""

    def __init__(self, z_size: int = 100, cond_dim: int = 0, num_channels: int = 3,
                 scale_factor: float = 1, dtype=None):
        super().__init__()
        self.latent_size = z_size
        self.dtype = dtype
        self.in_size = in_size = z_size + cond_dim
        s = scale_factor
        self.input_map = Linear(in_size, in_size, compute_dtype=dtype)
        self.input_bn = _bn(BatchNorm1d, in_size, dtype)
        chans = (in_size, int(512 * s), int(256 * s), int(128 * s), int(64 * s))
        self.dc0 = ConvTranspose3d(in_size, chans[1], (2, 6, 6), padding="VALID", bias=False,
                                   compute_dtype=dtype)
        self.bn0 = _bn(BatchNorm3d, chans[1], dtype)
        for i in range(1, 4):
            self.add_module(f"dc{i}", ConvTranspose3d(chans[i], chans[i + 1], 4, stride=2,
                                                      bias=False, compute_dtype=dtype))
            self.add_module(f"bn{i}", _bn(BatchNorm3d, chans[i + 1], dtype))
        self.dc4 = ConvTranspose3d(chans[4], num_channels, 1, bias=False, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, z, cond=None, train: bool | None = None):
        check_mode(self, train)
        x = z if cond is None else torch.cat([z, cond], dim=1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = _lrelu(self.input_bn(self.input_map(x)))
        x = x.reshape(x.shape[0], self.in_size, 1, 1, 1)
        for i in range(4):
            x = _lrelu(getattr(self, f"bn{i}")(getattr(self, f"dc{i}")(x)))
        return torch.tanh(self.dc4(x)).permute(0, 2, 3, 4, 1)


class VideoDiscrim(nn.Module):
    """x (B, T, H, W, C) [, cond (B, cond_dim)] -> (B,) float32 logits, the
    mean of the head's map per sample. With cond_dim > 0 the head is the
    conditional one (cond_map, cond_bn, pred0, pred_bn, pred1) and a cond
    must be given; with 0 it is `pred`. xbar is ignored."""

    def __init__(self, cond_dim: int = 256, mid_ch: int = 64, num_channels: int = 3,
                 negative_slope: float = 0.2, dtype=None):
        super().__init__()
        self.cond_dim, self.slope, self.dtype = cond_dim, negative_slope, dtype
        m = mid_ch
        chans = (num_channels, m, m * 2, m * 4, m * 8)
        for i in range(4):
            self.add_module(f"conv{i}", SameConv3d(chans[i], chans[i + 1], 4, stride=2,
                                                   bias=False, compute_dtype=dtype))
            if i:
                self.add_module(f"bn{i}", _bn(BatchNorm3d, chans[i + 1], dtype))
        if cond_dim:
            self.cond_map = Linear(cond_dim, cond_dim, compute_dtype=dtype)
            self.cond_bn = _bn(BatchNorm1d, cond_dim, dtype)
            self.pred0 = Conv3d(m * 8 + cond_dim, 512, 1, bias=False, compute_dtype=dtype)
            self.pred_bn = _bn(BatchNorm3d, 512, dtype)
            self.pred1 = Conv3d(512, 1, (1, 3, 3), bias=False, compute_dtype=dtype)
        else:
            self.pred = Conv3d(m * 8, 1, (1, 3, 3), stride=2, bias=False, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, x=None, cond=None, xbar=None):
        if (cond is not None) != bool(self.cond_dim):
            raise ValueError(f"VideoDiscrim(cond_dim={self.cond_dim}) called "
                             f"{'with' if cond is not None else 'without'} a cond")
        if self.dtype is not None:
            x = x.to(self.dtype)
        h = _lrelu(self.conv0(x.permute(0, 4, 1, 2, 3)), self.slope)
        for i in range(1, 4):
            h = _lrelu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)), self.slope)
        if cond is not None:
            if self.dtype is not None:
                cond = cond.to(self.dtype)
            c = _lrelu(self.cond_bn(self.cond_map(cond)), self.slope)
            c = c[:, :, None, None, None].expand(-1, -1, *h.shape[2:])
            h = _lrelu(self.pred_bn(self.pred0(torch.cat([h, c], dim=1))), self.slope)
            h = self.pred1(h)
        else:
            h = self.pred(h)
        return h.reshape(h.shape[0], -1).float().mean(dim=1)


class FrameMap(nn.Module):
    """The `--M` sample mapping: (B, T, H, W, C) -> (B, T, H', W', 512), a
    shared 2-D pyramid over each frame."""

    def __init__(self, num_channels: int = 3, dtype=None):
        super().__init__()
        self.dtype = dtype
        chans = (num_channels, 64, 128, 256, 512)
        for i in range(4):
            self.add_module(f"conv{i}", SameConv2d(chans[i], chans[i + 1], 4, stride=2,
                                                   bias=False, compute_dtype=dtype))
            if i < 3:
                self.add_module(f"bn{i}", _bn(BatchNorm2d, chans[i + 1], dtype))

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, videos):
        b, t = videos.shape[:2]
        h = videos.reshape((b * t,) + videos.shape[2:]).permute(0, 3, 1, 2)
        if self.dtype is not None:
            h = h.to(self.dtype)
        for i in range(3):
            h = _lrelu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h)))
        h = self.conv3(h).permute(0, 2, 3, 1)
        return h.reshape((b, t) + h.shape[1:])


class _SentTiledHead(nn.Module):
    """The frame and motion heads: a 1x1 conv over the (B, T, H', W', 512)
    maps, the sentence map tiled over (T, H', W') and concatenated, a 1x1
    conv and a 2x2 stride-2 conv to one logit per frame, averaged: (B, T)."""

    def __init__(self, cond_dim: int = 256, in_channels: int = 512, dtype=None):
        super().__init__()
        if not cond_dim:
            raise ValueError("the frame and motion discriminators need a cond (cond_dim > 0)")
        self.cond_dim, self.dtype = cond_dim, dtype
        self.sent_map = Linear(cond_dim, cond_dim, compute_dtype=dtype)
        self.sent_bn = _bn(BatchNorm1d, cond_dim, dtype)
        self.map = Conv2d(in_channels, 512, 1, bias=False, compute_dtype=dtype)
        self.map_bn = _bn(BatchNorm2d, 512, dtype)
        self.pred0 = Conv2d(512 + cond_dim, 512, 1, bias=False, compute_dtype=dtype)
        self.pred_bn = _bn(BatchNorm2d, 512, dtype)
        self.pred1 = Conv2d(512, 1, 2, stride=2, bias=False, compute_dtype=dtype)

    def init_weights(self, generator):
        init_kernels(self, generator)

    def forward(self, frames, cond):
        b, t = frames.shape[:2]
        if self.dtype is not None:
            frames, cond = frames.to(self.dtype), cond.to(self.dtype)
        sent = _lrelu(self.sent_bn(self.sent_map(cond)))
        h = frames.reshape((b * t,) + frames.shape[2:]).permute(0, 3, 1, 2)
        h = _lrelu(self.map_bn(self.map(h)))
        sent_t = sent.repeat_interleave(t, dim=0)[:, :, None, None].expand(-1, -1, *h.shape[2:])
        h = _lrelu(self.pred_bn(self.pred0(torch.cat([h, sent_t], dim=1))))
        h = self.pred1(h)
        return h.reshape(b, t, -1).float().mean(dim=-1)


class FrameDiscrim(nn.Module):
    """Per-frame conditional discriminator over FrameMap features:
    xbar (B, T, H', W', 512), cond -> (B, T). x is ignored."""

    def __init__(self, cond_dim: int = 256, dtype=None):
        super().__init__()
        self.head = _SentTiledHead(cond_dim, dtype=dtype)

    def forward(self, x=None, cond=None, xbar=None):
        return self.head(xbar, cond)


class MotionDiscrim(nn.Module):
    """FrameDiscrim on the temporal differences xbar[:, 1:] - xbar[:, :-1]
    -> (B, T - 1). x is ignored."""

    def __init__(self, cond_dim: int = 256, dtype=None):
        super().__init__()
        self.head = _SentTiledHead(cond_dim, dtype=dtype)

    def forward(self, x=None, cond=None, xbar=None):
        return self.head(xbar[:, 1:] - xbar[:, :-1], cond)
