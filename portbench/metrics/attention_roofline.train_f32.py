"""The least time of the traced steps' attention work in the float32
training cells (K1 for every attention outside the gradient penalty, K2
and K3 for those whose gradient is taken; the data-sheet peaks,
portbench/counts.py) over the device time of the attention kernels in the
traced segment. Nothing when no kernel of KERNELS ran."""

from portbench.trace import roofline_share

UNIT, LAYER, MOVES = "%", "attention kernels K1-K3", "train_videos_per_s.f32"
KERNELS = ("attention_fwd_kernel", "attention_bwd_dq_kernel", "attention_bwd_dkv_kernel",
           "dkv_reduce_kernel")


def read(ctx):
    return roofline_share(ctx, KERNELS)
