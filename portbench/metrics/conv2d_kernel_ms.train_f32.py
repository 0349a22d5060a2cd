"""Device ms per traced step of the port's float32 3x3 convolution kernels
(ops/conv.py: the convolution and input gradient, the weight gradient and
the split reduction's fixed-order sum) in the float32 training cells, from
the trace's kernel times. Nothing when none of KERNELS ran (a program
without them, whose convolutions run in cuDNN)."""

UNIT, LAYER, MOVES = "ms", "models", "train_videos_per_s.f32"
KERNELS = ("conv3x3_tc_kernel", "conv3x3_tc_wgrad_kernel", "conv3x3_tc_reduce_kernel")


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    spent = trace.kernel_s(KERNELS)
    steps = sum(1 for n, _, _ in trace.host if n == "trainer.step")
    if not spent or not steps:
        return None
    return 1e3 * spent / steps
