"""3D ResNet discriminator backbone (counterpart of txt2vid_tpu/models/resnet3d.py).

Stem residual block (conv3-ReLU-conv3 + (1,2,2)-kernel stride-2 average pool,
skip = pool + 1x1 conv), `num_down_blocks` DownBlocks doubling 128 -> ..., an
Attention3d after block 0 when with_attn, a float32 sum-pool over (T, H, W),
an unconditional scalar head and a conditional head over [features ‖ cond]
("concat") or psi(f) + cond^T V f ("proj"). The stem is a plain Conv3d: the JAX
package's `_C1Conv3d` holds the same parameters and only works around TPU lane
padding for 1-channel inputs.
"""

import torch
from torch import nn

from txt2vid_tpu_torch.models.layers import Attention3d, Conv3d, DownBlock, Linear, _init_conv
from txt2vid_tpu_torch.ops.initializers import RESIDUAL_GAIN
from txt2vid_tpu_torch.ops.pooling import avg_pool_3d

COND_HEADS = ("concat", "proj")


def avg_pool_122_s2(x):
    """(B, C, T, H, W) average pool, kernel (1, 2, 2), stride 2 in T as well:
    every other frame, 2x2 spatial averaging (resnet3d.py:101-107)."""
    return avg_pool_3d(x, (1, 2, 2), (2, 2, 2))


class Resnet3D(nn.Module):
    """x (B, T, H, W, C) [, cond (B, cond_dim)] -> (uncond (B, 1) | None,
    cond_logit (B, 1) | None, features (B, C_out), at least float32). With
    `computed_features` the backbone is skipped and uncond is None. `dtype`
    (bf16) is the stem's, the DownBlocks' and the attention's; the sum pool
    and the heads compute in float32, as flax's Dense layers without a dtype
    do."""

    def __init__(self, num_channels: int = 1, mid_ch: int = 64, cond_dim: int = 0,
                 num_down_blocks: int = 4, wide: bool = False, with_attn: bool = True,
                 cond_head: str = "concat", use_kernel: bool = True, dtype=None):
        super().__init__()
        if cond_head not in COND_HEADS:
            raise ValueError(f"cond_head {cond_head!r} is not one of {COND_HEADS}")
        self.cond_dim = cond_dim
        self.cond_head = cond_head
        self.num_down_blocks = num_down_blocks
        self.stem_conv1 = Conv3d(num_channels, mid_ch, 3, padding=1, compute_dtype=dtype)
        self.stem_conv2 = Conv3d(mid_ch, mid_ch, 3, padding=1, compute_dtype=dtype)
        self.stem_skip = Conv3d(num_channels, mid_ch, 1, compute_dtype=dtype)
        ch, out_ch = mid_ch, 128
        for i in range(num_down_blocks):
            self.add_module(f"down{i}", DownBlock(ch, out_ch, wide=wide, dtype=dtype))
            ch, out_ch = out_ch, out_ch * 2
        self.attn = (Attention3d(128, use_kernel, dtype)
                     if with_attn and num_down_blocks > 0 else None)
        self.fc_uncond = Linear(ch, 1)
        self.fc = self.cond_proj = None
        if cond_dim:
            if cond_head == "proj":
                self.cond_proj = Linear(cond_dim, ch, bias=False)
                self.fc = Linear(ch, 1)
            else:
                self.fc = Linear(ch + cond_dim, 1)

    def init_weights(self, generator):
        _init_conv(self.stem_conv1, generator, RESIDUAL_GAIN)
        _init_conv(self.stem_conv2, generator, RESIDUAL_GAIN)
        _init_conv(self.stem_skip, generator)
        for lin in (self.fc_uncond, self.fc, self.cond_proj):
            if lin is not None:
                _init_conv(lin, generator)

    def features(self, x):
        """x (B, T, H, W, C) -> the backbone features, sum-pooled in at least
    float32."""
        x = x.permute(0, 4, 1, 2, 3).contiguous()          # (B, C, T, H, W)
        h = self.stem_conv2(torch.relu(self.stem_conv1(x)))
        h = self.stem_skip(avg_pool_122_s2(x)) + avg_pool_122_s2(h)
        for i in range(self.num_down_blocks):
            h = getattr(self, f"down{i}")(h)
            if i == 0 and self.attn is not None:
                h = self.attn(h)
        return h.to(torch.promote_types(h.dtype, torch.float32)).sum(dim=(2, 3, 4))

    def forward(self, x=None, cond=None, computed_features=None):
        uncond = None
        if computed_features is not None:
            feats = computed_features
        else:
            feats = self.features(x)
            uncond = self.fc_uncond(feats)
        if cond is None:
            return uncond, None, feats
        if not self.cond_dim:
            raise ValueError("a cond was given to a Resnet3D built with cond_dim=0")
        cond = cond.to(feats.dtype)
        if self.cond_head == "proj":
            cond_logit = self.fc(feats) + (self.cond_proj(cond) * feats).sum(1, keepdim=True)
        else:
            cond_logit = self.fc(torch.cat([feats, cond], dim=1))
        return uncond, cond_logit, feats
