"""TGANv2 multi-scale generator, eval mode (counterpart of
txt2vid_tpu/models/tganv2.py).

z [‖ cond] -> fc -> (fm_h, fm_w, fm_channels) latent plane -> ConvLSTM unroll of
`num_frames` steps -> frames folded into the batch -> base UpBlock stack
1024-512-256-128 -> `additional_blocks` UpBlocks, each paired with a RenderBlock.
At eval only the final scale is rendered (plus any `output_blocks`). Training
(the subsample pyramid between blocks) and the discriminator wait for the
training slice.
"""

from collections.abc import Sequence

import torch
from torch import nn

from txt2vid_tpu_torch.models.conv_lstm import ConvLSTM
from txt2vid_tpu_torch.models.layers import RenderBlock, UpBlock
from txt2vid_tpu_torch.ops.initializers import xavier_normal_


class BaseFrameGen(nn.Module):
    """UpBlock stack in_channels -> 512 -> 256 -> 128."""

    def __init__(self, in_channels: int = 1024, out_channels: int = 128):
        super().__init__()
        self.up0 = UpBlock(in_channels, 512)
        self.up1 = UpBlock(512, 256)
        self.up2 = UpBlock(256, out_channels)

    def forward(self, x):
        return self.up2(self.up1(self.up0(x)))


class MultiScaleGen(nn.Module):
    """z: (B, latent_size) [, cond: (B, cond_dim)] -> list of rendered videos
    (B, T, H, W, C), the JAX layout. `with_non_local` puts an Attention after
    additional block len-2 (the conditional variant)."""

    def __init__(self, latent_size: int = 256, width: int = 128, height: int = 128,
                 num_channels: int = 3, additional_blocks: Sequence[int] = (64, 32, 32),
                 fm_channels: int = 1024, num_frames: int = 16, cond_dim: int = 0,
                 fm_stride: int | None = None, with_non_local: bool = False,
                 use_kernel: bool = True):
        super().__init__()
        self.latent_size = latent_size
        self.num_frames = num_frames
        self.fm_channels = fm_channels
        stride = fm_stride or 64
        self.fm_w = max(1, width // stride)
        self.fm_h = max(1, height // stride)
        self.fc = nn.Linear(latent_size + cond_dim,
                            self.fm_h * self.fm_w * fm_channels)
        self.clstm = ConvLSTM(fm_channels, (fm_channels,), kernel_size=3,
                              step=num_frames)
        self.base = BaseFrameGen(fm_channels)
        self.render_base = RenderBlock(128, num_channels)
        self.num_blocks = 1 + len(additional_blocks)
        prev = 128
        for i, ch in enumerate(additional_blocks):
            self.add_module(f"up{i}", UpBlock(
                prev, ch, use_kernel=use_kernel,
                with_non_local=with_non_local and i == len(additional_blocks) - 2))
            self.add_module(f"render{i}", RenderBlock(ch, num_channels))
            prev = ch

    def init_weights(self, generator):
        xavier_normal_(self.fc.weight, generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, z, cond=None, train: bool = False, output_blocks=None):
        if train:
            raise NotImplementedError(
                "train=True (the subsample pyramid) comes with the training slice")
        x = z if cond is None else torch.cat([z, cond], dim=1)
        b = x.shape[0]
        # the fc's outputs are (fm_h, fm_w, C) in the JAX layout; NCHW after
        x = self.fc(x).reshape(b, self.fm_h, self.fm_w, self.fm_channels)
        x = self.clstm(x.permute(0, 3, 1, 2))            # (B, T, C, h, w)
        x = x.reshape((-1,) + x.shape[2:])               # fold time into batch

        blocks = [self.base] + [getattr(self, f"up{i}") for i in range(self.num_blocks - 1)]
        renders = [self.render_base] + [getattr(self, f"render{i}")
                                        for i in range(self.num_blocks - 1)]
        rendered = []
        for i, (block, render) in enumerate(zip(blocks, renders)):
            x = block(x)
            if i == len(blocks) - 1 or (output_blocks is not None and i in output_blocks):
                r = render(x).permute(0, 2, 3, 1)        # (B*T, H, W, C)
                rendered.append(r.reshape((b, self.num_frames) + r.shape[1:]))
        return rendered
