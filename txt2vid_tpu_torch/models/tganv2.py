"""TGANv2 multi-scale generator and discriminator (counterpart of
txt2vid_tpu/models/tganv2.py).

Generator: z [‖ cond] -> fc -> (fm_h, fm_w, fm_channels) latent plane ->
ConvLSTM unroll of `num_frames` steps (or, with `no_lstm`, TGAN's
FrameSeedGenerator expanding the fc output into 16 per-frame planes, cut to
num_frames <= 16; it gets no dtype, as in the JAX package, so under bf16 it
computes in float32 from the bf16 fc output) -> frames folded into the batch -> base
UpBlock stack 1024-512-256-128 -> `additional_blocks` UpBlocks, each paired
with a RenderBlock. In training a subsample (batch and frames halve, random
temporal phase) runs before every block after the base and every scale is
rendered; at eval only the final scale is rendered (plus any `output_blocks`).
BatchNorm follows the module's train/eval mode, which must agree with `train`.

Discriminator: one shared (or one per scale) Resnet3D applied to the
positional list of scales.

`remat` (both) recomputes the activations of the same blocks flax's nn.remat
wraps in the JAX package (tganv2.py:120-123,183-185) in the backward instead
of keeping them: the generator's base and each additional UpBlock, the
discriminator's every Resnet3D call (layers.remat). The subsamples stay
outside the wrapped blocks. Numerics do not change.

`dtype` (None or torch.bfloat16; "bfloat16" as a spec gives it, config.py)
is flax's compute dtype (tganv2.py:33-42,68-137,172-208): parameters stay
float32 and every block casts at each use. The generator casts z [‖ cond]
before fc and returns bf16 videos; the discriminator casts each scale before
its Resnet3D, whose features and logits are float32.
"""

from collections.abc import Sequence

import torch
from torch import nn

from txt2vid_tpu_torch.models.conv_lstm import ConvLSTM
from txt2vid_tpu_torch.models.layers import Linear, RenderBlock, UpBlock, remat
from txt2vid_tpu_torch.models.resnet3d import Resnet3D
from txt2vid_tpu_torch.models.tgan import FrameSeedGenerator
from txt2vid_tpu_torch.ops.batch_group import subsample_start
from txt2vid_tpu_torch.ops.initializers import kernel_init_
from txt2vid_tpu_torch.ops.subsample import subsample_video


class BaseFrameGen(nn.Module):
    """UpBlock stack in_channels -> 512 -> 256 -> 128."""

    def __init__(self, in_channels: int = 1024, out_channels: int = 128, dtype=None):
        super().__init__()
        self.up0 = UpBlock(in_channels, 512, dtype=dtype)
        self.up1 = UpBlock(512, 256, dtype=dtype)
        self.up2 = UpBlock(256, out_channels, dtype=dtype)

    def forward(self, x):
        return self.up2(self.up1(self.up0(x)))


class MultiScaleGen(nn.Module):
    """z: (B, latent_size) [, cond: (B, cond_dim)] -> list of rendered videos
    (B, T, H, W, C), the JAX layout. `with_non_local` puts an Attention after
    additional block len-2 (the conditional variant)."""

    def __init__(self, latent_size: int = 256, width: int = 128, height: int = 128,
                 num_channels: int = 3, additional_blocks: Sequence[int] = (64, 32, 32),
                 fm_channels: int = 1024, num_frames: int = 16, cond_dim: int = 0,
                 no_lstm: bool = False, fm_stride: int | None = None,
                 with_non_local: bool = False,
                 use_kernel: bool = True, remat: bool = False, dtype=None):
        super().__init__()
        self.remat = remat
        self.dtype = dtype
        self.latent_size = latent_size
        self.num_frames = num_frames
        self.fm_channels = fm_channels
        stride = fm_stride or 64
        self.fm_w = max(1, width // stride)
        self.fm_h = max(1, height // stride)
        self.fc = Linear(latent_size + cond_dim, self.fm_h * self.fm_w * fm_channels,
                         compute_dtype=dtype)
        self.no_lstm = no_lstm
        if no_lstm:
            if num_frames > 16:
                raise ValueError("the no_lstm path generates at most 16 frames")
            fm_size = self.fm_h * self.fm_w * fm_channels
            self.frame_seed_gen = FrameSeedGenerator(fm_size, fm_size)
        else:
            self.clstm = ConvLSTM(fm_channels, (fm_channels,), kernel_size=3,
                                  step=num_frames, dtype=dtype)
        self.base = BaseFrameGen(fm_channels, dtype=dtype)
        self.render_base = RenderBlock(128, num_channels, dtype)
        self.num_blocks = 1 + len(additional_blocks)
        prev = 128
        for i, ch in enumerate(additional_blocks):
            self.add_module(f"up{i}", UpBlock(
                prev, ch, use_kernel=use_kernel,
                with_non_local=with_non_local and i == len(additional_blocks) - 2,
                dtype=dtype))
            self.add_module(f"render{i}", RenderBlock(ch, num_channels, dtype))
            prev = ch

    def init_weights(self, generator):
        kernel_init_(self.fc.weight, generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, z, cond=None, train: bool = False, output_blocks=None,
                phases=None, generator: torch.Generator | None = None):
        """-> list of rendered videos (B_i, T_i, H_i, W_i, C). With train=True
        (the module in training mode) the subsample before block i >= 1 takes
        the temporal phase phases[i - 1], or draws it from `generator`."""
        if train != self.training:
            raise ValueError(f"forward(train={train}) on a module in "
                             f"{'training' if self.training else 'eval'} mode")
        if train and phases is None:
            phases = [int(torch.randint(0, 2, (), generator=generator))
                      for _ in range(self.num_blocks - 1)]
        if train and len(phases) != self.num_blocks - 1:
            raise ValueError(f"{self.num_blocks - 1} phases needed, got {len(phases)}")
        x = z if cond is None else torch.cat([z, cond], dim=1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        b = x.shape[0]
        # the fc's outputs (and the seeds) are (fm_h, fm_w, C) in the JAX
        # layout; NCHW after
        x = self.fc(x)
        num_frames = self.num_frames
        if self.no_lstm:
            x = self.frame_seed_gen(x)[:, :num_frames]    # (B, T, fm_size) float32
            x = x.reshape(b, num_frames, self.fm_h, self.fm_w, self.fm_channels)
            x = x.permute(0, 1, 4, 2, 3)                  # (B, T, C, h, w)
        else:
            x = x.reshape(b, self.fm_h, self.fm_w, self.fm_channels)
            x = self.clstm(x.permute(0, 3, 1, 2))        # (B, T, C, h, w)
        x = x.reshape((-1,) + x.shape[2:])               # fold time into batch

        blocks = [self.base] + [getattr(self, f"up{i}") for i in range(self.num_blocks - 1)]
        renders = [self.render_base] + [getattr(self, f"render{i}")
                                        for i in range(self.num_blocks - 1)]
        rendered = []
        for i, (block, render) in enumerate(zip(blocks, renders)):
            if i != 0 and train:
                v = x.reshape((-1, num_frames) + x.shape[1:])
                v = subsample_video(v, phases[i - 1], start=subsample_start(i - 1))
                num_frames //= 2
                x = v.reshape((-1,) + v.shape[2:])
            x = remat(block, x) if self.remat and torch.is_grad_enabled() else block(x)
            if i == len(blocks) - 1 or train or (output_blocks is not None
                                                 and i in output_blocks):
                r = render(x).permute(0, 2, 3, 1)        # (B*T, H, W, C)
                rendered.append(r.reshape((-1, num_frames) + r.shape[1:]))
        return rendered


class MultiScaleDiscrim(nn.Module):
    """Positional list of scales (B_i, T_i, H_i, W_i, C) [, conds] -> list of
    (uncond, cond, features) triples, one per scale (tganv2.py:157-212).
    `single_discrim` shares one Resnet3D (`discrim`, with the last entry of
    discrim_down_blocks) across scales; otherwise scale i has `discrim{i}`.
    `scale_indices` maps positional inputs to sub-discriminators."""

    is_multiscale = True

    def __init__(self, discrim_down_blocks: Sequence[int] = (4, 4, 4, 4),
                 num_channels: int = 3, cond_dim: int = 0, single_discrim: bool = True,
                 wide: bool = False, with_attn: bool = True, cond_head: str = "concat",
                 use_kernel: bool = True, remat: bool = False, dtype=None):
        super().__init__()
        self.single_discrim = single_discrim
        self.remat = remat
        self.dtype = dtype

        def make(db):
            return Resnet3D(num_channels=num_channels, cond_dim=cond_dim,
                            num_down_blocks=db, wide=wide, with_attn=with_attn,
                            cond_head=cond_head, use_kernel=use_kernel, dtype=dtype)

        if single_discrim:
            self.discrim = make(discrim_down_blocks[-1])
        else:
            for i, db in enumerate(discrim_down_blocks):
                self.add_module(f"discrim{i}", make(db))

    def sub(self, i: int) -> Resnet3D:
        return self.discrim if self.single_discrim else getattr(self, f"discrim{i}")

    def forward(self, x, cond=None, computed_features=None, scale_indices=None):
        if scale_indices is None:
            scale_indices = range(len(x))
        out = []
        for pos, (si, scale) in enumerate(zip(scale_indices, x)):
            if self.dtype is not None:
                scale = scale.to(self.dtype)
            args = (scale, cond[pos] if cond is not None else None,
                    computed_features[pos] if computed_features is not None else None)
            sub = self.sub(si)
            out.append(remat(sub, *args) if self.remat and torch.is_grad_enabled()
                       else sub(*args))
        return out
