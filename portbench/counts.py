"""Operations and bytes: the data-sheet peaks of one H100 (SXM, dense, at
700 W), the FLOPs of a train step or a served chunk counted on the plain
reference, and the least time of the attention kernels' work.

The FLOP count runs the reference on the `meta` device and sums
torch.utils.flop_counter's formulas over the operators it dispatches:
convolutions, matmuls (the LSTM is written as matmuls) and the attention's
two products, forward and backward, and on a gradient-penalty step the
double backward. Elementwise
work, pooling, softmax and BatchNorm are not counted; nothing is counted
twice for recomputation. The count depends on the configuration alone.
"""

import torch

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def conv_flops(batch, cin, cout, kernel, out_spatial) -> int:
    """2 * multiply-adds of a convolution: every output element takes
    cin * prod(kernel) products."""
    n = batch * cout
    for s in out_spatial:
        n *= s
    k = cin
    for s in kernel:
        k *= s
    return 2 * n * k


def attention_cost(kernel: str, b, n, m, d, dv, dtype: str):
    """(FLOP, bytes) of one launch: K1 the forward (o and the row
    log-sum-exp), K2 the query gradient, K3 the key and value gradients.
    Each input is read once and each output written once."""
    item = ITEM_BYTES[dtype]
    rows = b * n * 4                           # one float32 per query row
    q, k, v, o = b * n * d * item, b * m * d * item, b * m * dv * item, b * n * dv * item
    if kernel == "K1":
        return 2 * b * n * m * (d + dv), q + k + v + o + rows
    if kernel == "K2":
        return 2 * b * n * m * (2 * d + dv), q + k + v + o + 2 * rows + q
    if kernel == "K3":
        return 2 * b * n * m * (2 * d + 2 * dv), q + k + v + o + 2 * rows + k + v
    raise ValueError(kernel)


def least_time_s(kernel, b, n, m, d, dv, dtype) -> float:
    flops, nbytes = attention_cost(kernel, b, n, m, d, dv, dtype)
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def attention_least_s(calls, dtype: str) -> float:
    """Least time of the kernels' work for logged attention calls
    (b, n, m, d, dv, with_grad): K1 for each, K2 and K3 for those whose
    gradient is taken."""
    total = 0.0
    for b, n, m, d, dv, with_grad in calls:
        total += least_time_s("K1", b, n, m, d, dv, dtype)
        if with_grad:
            total += (least_time_s("K2", b, n, m, d, dv, dtype)
                      + least_time_s("K3", b, n, m, d, dv, dtype))
    return total


class FlopCount:
    """Sums torch.utils.flop_counter's formulas over the operators that run
    inside it (FlopCounterMode's count, without its module tracking, which
    does not follow a gradient taken with respect to a leaf)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    counter.total += formula(*args, **kwargs, out_val=out)
                return out

        self.total = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _counted(fn):
    from portbench.reference.models import AttnLog
    log = AttnLog()
    with FlopCount() as counter, log.active():
        fn()
    return counter.total, list(log)


def train_step_counts(spec: dict, vocab_size: int) -> dict:
    """{"gp": (flops, attention calls), "plain": (...)} of one train step at
    the configuration's batch, on the meta device."""
    from portbench.reference.train import ReferenceTrainer, draws
    t = spec["train"]
    g = spec["G"]["args"]
    meta = torch.device("meta")
    shape = (t["batch_size"], g["num_frames"], g["width"], g["width"], g["num_channels"])
    out = {}
    for kind, index in (("gp", 0), ("plain", 1)):
        if kind == "gp" and not t["gp_lambda"] > 0:
            continue
        ref = ReferenceTrainer(spec, vocab_size, None, meta, remat=False)
        ref.step_index = index
        dr = draws(0, index, t["batch_size"], g["latent_size"], len(t["frame_sizes"]),
                   t["subsample_input"], ref.G.num_blocks, t["gp_lambda"] > 0)
        video = torch.empty(shape, dtype=torch.uint8, device=meta)
        ids = torch.zeros((t["batch_size"], t["max_caption_len"]), dtype=torch.long,
                          device=meta)
        lengths = torch.full((t["batch_size"],), t["max_caption_len"])
        out[kind] = _counted(lambda: ref.step(video, ids, lengths, dr))
    return out


def serve_chunk_counts(spec: dict, vocab_size: int, batch: int, caption_len: int):
    """(flops, attention calls) of one served chunk: the encoder and the
    generator's eval forward at the last scale."""
    from portbench.reference.train import build
    meta = torch.device("meta")
    G, _, E = build(spec, vocab_size, meta, remat=False)
    G.eval()

    def run():
        with torch.no_grad():
            cond = E(torch.zeros((batch, caption_len), dtype=torch.long, device=meta),
                     torch.full((batch,), caption_len))
            G(torch.empty((batch, G.latent_size), device=meta), cond)

    return _counted(run)
