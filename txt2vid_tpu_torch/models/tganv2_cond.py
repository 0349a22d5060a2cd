"""Conditional TGANv2 (counterpart of txt2vid_tpu/models/tganv2_cond.py): the
generator's fc consumes [z ‖ cond] and the second-to-last additional UpBlock
carries a non-local Attention; the discriminator threads per-scale cond
vectors into the Resnet3D heads."""

from functools import partial

from txt2vid_tpu_torch.models import tganv2

MultiScaleGen = partial(tganv2.MultiScaleGen, width=64, height=64,
                        cond_dim=256, with_non_local=True)
MultiScaleDiscrim = partial(tganv2.MultiScaleDiscrim, cond_dim=256)
