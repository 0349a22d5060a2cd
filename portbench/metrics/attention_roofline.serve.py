"""The least time of the traced segment's K1 work (one attention per served
chunk; the data-sheet peaks, portbench/counts.py) over the device time of
K1 in it. Nothing when K1 did not run."""

from portbench.trace import roofline_share

UNIT, LAYER, MOVES = "%", "attention kernels K1-K3", "serve_p95_ms"
KERNELS = ("attention_fwd_kernel",)


def read(ctx):
    return roofline_share(ctx, KERNELS)
