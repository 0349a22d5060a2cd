"""The FLOP and byte counts behind the mfu metrics and the attention
rooflines."""

import json

import pytest
import torch
import torch.nn.functional as F

from portbench import counts, data
from portbench.manifest import HERE
from portbench.reference.train import build
from portbench.tests import tiny


def test_one_convolution_by_hand():
    # (2, 3, 5, 5) -> (2, 4, 5, 5) with a 3x3 kernel: each of 2*4*5*5 outputs
    # takes 3*3*3 multiply-adds
    assert counts.conv_flops(2, 3, 4, (3, 3), (5, 5)) == 2 * (2 * 4 * 5 * 5) * (3 * 3 * 3)
    with counts.FlopCount() as c:
        F.conv2d(torch.zeros(2, 3, 5, 5, device="meta"), torch.zeros(4, 3, 3, 3, device="meta"),
                 padding=1)
    assert c.total == counts.conv_flops(2, 3, 4, (3, 3), (5, 5))


def test_k1_bound_at_the_64px_shape():
    flops, nbytes = counts.attention_cost("K1", 40, 1024, 256, 4, 16, "float32")
    assert flops == 2 * 40 * 1024 * 256 * 20 == 419430400
    ms = 1e3 * counts.least_time_s("K1", 40, 1024, 256, 4, 16, "float32")
    assert ms == pytest.approx(0.00626, abs=5e-6)
    assert nbytes / counts.PEAK_BYTES_PER_S < flops / counts.PEAK_FLOPS["float32"]


def test_forward_count_is_the_sum_of_its_products():
    """The meta count of the encoder and the generator's eval forward equals
    their convolutions, dense layers, LSTM matmuls and attention products
    counted by hand from the shapes they ran at."""
    spec = tiny.spec()
    vocab = len(data.vocabulary())
    G, _, E = build(spec, vocab, "cpu", remat=False)
    G.eval()
    b, length = 3, 7
    by_hand = 0

    def conv_hook(m, inp, out):
        nonlocal by_hand
        by_hand += counts.conv_flops(out.shape[0], m.weight.shape[1], m.weight.shape[0],
                                     m.weight.shape[2:], out.shape[2:])

    def linear_hook(m, inp, out):
        nonlocal by_hand
        by_hand += 2 * out.numel() * m.weight.shape[1]

    for m in G.modules():
        kind = type(m).__name__
        if kind == "Conv":
            m.register_forward_hook(conv_hook)
        elif kind == "Linear":
            m.register_forward_hook(linear_hook)
    g, e = spec["G"]["args"], spec["sent"]["args"]
    h = e["hidden_size"] // 2
    for k in range(e["num_layers"]):
        cin = e["embed_size"] if k == 0 else e["hidden_size"]
        by_hand += 2 * (2 * b * length * cin * 4 * h + length * 2 * b * h * 4 * h)
    # the attention at the second-to-last additional block: N tokens,
    # N / 4 keys, d = C / 8, dv = C / 2, over every frame
    ch = g["additional_blocks"][-2]
    side = g["width"] // 2
    n = side * side
    by_hand += 2 * (b * g["num_frames"]) * n * (n // 4) * (ch // 8 + ch // 2)
    z = torch.zeros(b, g["latent_size"])
    ids = torch.ones(b, length, dtype=torch.long)
    with torch.no_grad():
        G(z, E(ids, torch.full((b,), length)))
    total, calls = counts._counted(lambda: None)
    assert total == 0 and calls == []
    flops, calls = counts.serve_chunk_counts(spec, vocab, b, length)
    assert flops == by_hand
    assert len(calls) == 1


def test_step_counts_follow_the_step():
    spec = tiny.spec()
    c = counts.train_step_counts(spec, len(data.vocabulary()))
    fwd, _ = counts.serve_chunk_counts(spec, len(data.vocabulary()), 4, 32)
    assert c["gp"][0] > c["plain"][0] > fwd
    # the generator's attention and four per scale in D (real, fake, the
    # updated D's reals, the G loss), none of them in the penalty
    assert len(c["gp"][1]) == len(c["plain"][1]) == 1 + 4 * len(spec["train"]["frame_sizes"])


@pytest.mark.parametrize("name", ["tganv2_cond128", "tganv2_cond64"])
def test_configured_steps_count(name):
    spec = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c = counts.train_step_counts(spec, len(data.vocabulary()))
    assert all(flops > 1e11 for flops, _ in c.values())
