"""The 3x3 convolution ops (ops/conv.py) and their routing
(models/layers.Conv2d) on the CPU, at tiny shapes and one torch thread.

- The three autograd Functions' plain paths (F.conv2d and torch.nn.grad's
  input and weight gradients) pass gradcheck and gradgradcheck in float64:
  each op's backward calls the other two, so a gradient through a gradient
  stays on them.
- The routing rule, device-agnostic (`takes_conv_kernel` with the device
  type as an argument): the cond-128 generator's ten UpBlock 3x3
  convolutions and its two ConvLSTM gate convolutions take the kernels; its
  1x1 convolutions, render convolutions (C_out = 1), a SameConv2d, a bf16
  Conv2d and a Conv3d do not; no_kernel() and a CPU device send every one to
  F.conv2d.
- A Conv2d's output and gradients equal F.conv2d's on the CPU.
- The kernels' tile plans (`conv_plan`, `wgrad_plan`): every position and
  channel chunk is covered once, the halo fits its copies, shared memory and
  the split reduction's scratch fit their limits, the splits fill the card
  where the tiles alone would not, and the shared-memory strides put a
  warp's fragment reads on distinct banks at the cond-128 shapes.
"""

import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.models import layers
from txt2vid_tpu_torch.ops import conv
from txt2vid_tpu_torch.ops.attention import no_kernel

COND128 = Path(__file__).resolve().parents[1] / "portbench" / "configs" / "tganv2_cond128.json"
# (n, cin, cout, h, w): the cond-128 generator's convolutions in a training
# step, and odd shapes
CELL_SHAPES = conv.COND128_SHAPES
ODD_SHAPES = [(2, 5, 9, 3, 4), (3, 12, 40, 5, 7), (1, 9, 70, 2, 2), (2, 4, 130, 6, 33),
              (5, 3, 8, 1, 1), (1, 1, 8, 1, 40)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("bias", [True, False])
def test_conv_function_gradcheck(bias):
    x, w = _f64(2, 3, 4, 5), _f64(4, 3, 3, 3, seed=1)
    b = _f64(4, seed=2) if bias else None
    assert torch.autograd.gradcheck(conv.Conv3x3.apply, (x, w, b))
    assert torch.autograd.gradgradcheck(conv.Conv3x3.apply, (x, w, b))


def test_input_grad_function_gradcheck():
    dy, w = _f64(2, 4, 3, 5), _f64(4, 3, 3, 3, seed=1)
    assert torch.autograd.gradcheck(conv.Conv3x3InputGrad.apply, (dy, w))
    assert torch.autograd.gradgradcheck(conv.Conv3x3InputGrad.apply, (dy, w))


def test_weight_grad_function_gradcheck():
    x, dy = _f64(2, 3, 4, 3), _f64(2, 4, 4, 3, seed=1)
    assert torch.autograd.gradcheck(conv.Conv3x3WeightGrad.apply, (x, dy))
    assert torch.autograd.gradgradcheck(conv.Conv3x3WeightGrad.apply, (x, dy))


def test_plain_versions_match_autograd_of_f_conv2d():
    x, w, dy = _f64(2, 3, 5, 4), _f64(6, 3, 3, 3, seed=1), _f64(2, 6, 5, 4, seed=2)
    y = F.conv2d(x, w, padding=1)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.testing.assert_close(conv.conv3x3_reference(x, w), y, rtol=0, atol=0)
    torch.testing.assert_close(conv.conv3x3_input_grad_reference(dy, w), gx)
    torch.testing.assert_close(conv.conv3x3_weight_grad_reference(x, dy), gw)


def test_double_backward_through_the_ops_matches_f_conv2d():
    """The gradient penalty's pattern: a gradient taken with create_graph,
    then differentiated again, through the Functions and through F.conv2d."""
    def penalty(fn):
        x, w, b = _f64(2, 3, 4, 5), _f64(5, 3, 3, 3, seed=1), _f64(5, seed=2)
        y = fn(x, w, b)
        gx, = torch.autograd.grad((y.tanh() ** 2).sum(), x, create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), (x, w, b))
    for got, want in zip(penalty(conv.Conv3x3.apply),
                         penalty(lambda x, w, b: F.conv2d(x, w, b, padding=1))):
        torch.testing.assert_close(got, want)


def _cond128_gen():
    spec = json.loads(COND128.read_text())["G"]
    with torch.device("meta"):
        return create_object(spec)


def test_routing_rule_on_the_cond128_generator():
    gen = _cond128_gen()
    taken = sorted(name for name, m in gen.named_modules()
                   if isinstance(m, torch.nn.Conv2d)
                   and layers.takes_conv_kernel(m, "cuda", torch.float32))
    ups = [f"{blk}.conv{i}" for blk in ("base.up0", "base.up1", "base.up2", "up0", "up1")
           for i in (1, 2)]
    assert taken == sorted(ups + ["clstm.cells.wh0", "clstm.wx0"])
    left = {name for name, m in gen.named_modules()
            if isinstance(m, torch.nn.Conv2d) and name not in taken}
    # 1x1: the identity paths and the attention's projections; C_out = 1: renders
    assert left and all(getattr(gen.get_submodule(n), "kernel_size") == (1, 1)
                        or gen.get_submodule(n).out_channels == 1 for n in left)
    assert {n for n in left if n.startswith("render")} == {"render0.conv", "render1.conv",
                                                          "render_base.conv"}
    # in bf16 none takes them
    assert not any(layers.takes_conv_kernel(m, "cuda", torch.bfloat16) for m in gen.modules()
                   if isinstance(m, torch.nn.Conv2d))


def test_routing_rule_on_other_layers():
    with torch.device("meta"):
        same = layers.SameConv2d(8, 16, 3)
        one = layers.Conv2d(8, 16, 1)
        plain = layers.Conv2d(8, 16, 3, padding=1)
        bf16 = layers.Conv2d(8, 16, 3, padding=1, compute_dtype=torch.bfloat16)
        render = layers.RenderBlock(16, 1).conv
        rgb = layers.RenderBlock(16, 3).conv
        seven = layers.Conv2d(8, 7, 3, padding=1)
        strided = layers.Conv2d(8, 16, 3, padding=1, stride=2)
        dilated = layers.Conv2d(8, 16, 3, padding=2, dilation=2)
        grouped = layers.Conv2d(8, 16, 3, padding=1, groups=2)
        reflect = layers.Conv2d(8, 16, 3, padding=1, padding_mode="reflect")
        conv3d = layers.Conv3d(8, 16, 3, padding=1)
    assert layers.takes_conv_kernel(plain, "cuda", torch.float32)
    for m in (same, one, render, rgb, seven, strided, dilated, grouped, reflect):
        assert not layers.takes_conv_kernel(m, "cuda", torch.float32), m
    assert not layers.takes_conv_kernel(plain, "cuda", torch.bfloat16)
    assert not layers.takes_conv_kernel(plain, "cuda", torch.float64)
    # the dtype the rule sees is the promoted one: a bf16 compute dtype casts
    # a float32 input to bf16 first
    x = torch.empty(1, 8, 4, 4, device="meta")
    assert layers.promote(bf16.compute_dtype, x, bf16.weight)[0].dtype == torch.bfloat16
    assert not isinstance(conv3d, torch.nn.Conv2d)
    # Conv3d and ConvTranspose2d are no Conv2d: the rule is never asked


def test_routing_needs_cuda_and_yields_to_no_kernel():
    with torch.device("meta"):
        plain = layers.Conv2d(8, 16, 3, padding=1)
    assert layers.takes_conv_kernel(plain, "cuda", torch.float32)
    assert not layers.takes_conv_kernel(plain, "cpu", torch.float32)
    with no_kernel():
        assert not layers.takes_conv_kernel(plain, "cuda", torch.float32)
    assert layers.takes_conv_kernel(plain, "cuda", torch.float32)


def test_module_matches_f_conv2d_on_the_cpu():
    torch.manual_seed(0)
    m = layers.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 5, 6, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    y = m(x)
    y2 = F.conv2d(x2, m.weight, m.bias, padding=1)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    g = torch.randn_like(y)
    gx, gw, gb = torch.autograd.grad(y, (x, m.weight, m.bias), g)
    gx2, gw2, gb2 = torch.autograd.grad(y2, (x2, m.weight, m.bias), g)
    for a, b in ((gx, gx2), (gw, gw2), (gb, gb2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_ops_count_no_launch():
    counters = (conv.conv3x3, conv.conv3x3_input_grad, conv.conv3x3_weight_grad,
                conv.conv3x3_reduce)
    before = [c.launches for c in counters]
    x, w = torch.randn(1, 2, 3, 3), torch.randn(4, 2, 3, 3)
    dy = conv.conv3x3(x, w)
    conv.conv3x3_input_grad(dy, w)
    conv.conv3x3_weight_grad(x, dy)
    assert [c.launches for c in counters] == before


def _slot_positions(plan_ti, plan_th, plan_tw):
    return plan_ti * plan_th * plan_tw


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape", CELL_SHAPES + ODD_SHAPES)
def test_conv_plan_covers_the_problem(shape, flip):
    n, cin, cout, h, w = shape
    if flip:
        cin, cout = cout, cin
    p = conv.conv_plan(n, cin, cout, h, w, flip, 132)
    bn, threads, _ = conv.CONV_TILES[p.cfg]
    assert p.bn == bn and (cout > 32) == (bn == 64)
    assert _slot_positions(p.ti, p.th, p.tw) <= conv.CONV_SLOTS
    halo = p.ti * (p.th + 2) * (p.tw + 2)
    assert halo <= conv.MAX_HALO_PER_THREAD * threads and p.cs >= halo
    # tiles cover every position; splits cover every chunk of 8 channels once
    assert -(-n // p.ti) * p.ti >= n and p.tiles_h * p.th >= h and p.tiles_w * p.tw >= w
    assert p.pos_tiles == -(-n // p.ti) * p.tiles_h * p.tiles_w
    assert p.co_tiles * bn >= cout > (p.co_tiles - 1) * bn
    chunks = -(-cin // conv.CHUNK)
    assert (p.splits - 1) * p.cps < chunks <= p.splits * p.cps
    assert p.smem_bytes <= conv.SMEM_LIMIT
    rows = conv.CHUNK if flip else bn
    assert p.smem_bytes == 4 * (2 * conv.TAPS * bn * conv.CHUNK
                                + conv.CONV_STAGES * (conv.CHUNK * p.cs + rows * p.sb))
    # two blocks on an SM, as the kernel's launch bounds ask
    assert conv._resident(2, p.smem_bytes) == 2
    assert p.sb % 4 == 0 and p.sb >= (bn * conv.TAPS if flip else conv.CHUNK * conv.TAPS)
    if p.splits > 1:
        assert p.splits * n * cout * h * w * 4 <= conv.SCRATCH_LIMIT


@pytest.mark.parametrize("shape", CELL_SHAPES + ODD_SHAPES)
def test_wgrad_plan_covers_the_problem(shape):
    n, cin, cout, h, w = shape
    p = conv.wgrad_plan(n, cin, cout, h, w, 132)
    bm, threads, _ = conv.WGRAD_TILES[p.cfg]
    assert p.bm == bm and p.threads == threads
    assert _slot_positions(p.ti, p.th, p.tw) <= conv.WGRAD_SLOTS
    halo = p.ti * (p.th + 2) * (p.tw + 2)
    assert halo <= conv.MAX_HALO_PER_THREAD * threads and p.cs >= halo
    assert p.nq == -(-n // p.ti) * p.tiles_h * p.tiles_w
    assert p.tiles_h * p.th >= h and p.tiles_w * p.tw >= w
    assert (p.splits - 1) * p.qps < p.nq <= p.splits * p.qps
    assert p.co_tiles * bm >= cout and p.ci_tiles * conv.WGRAD_CHANNELS >= cin
    assert p.smem_bytes <= conv.SMEM_LIMIT
    if p.splits > 1:
        assert p.splits * cout * cin * 9 * 4 <= conv.SCRATCH_LIMIT


def test_splits_fill_the_card_where_tiles_do_not():
    # the ConvLSTM's input gradient: 4 x 16 tiles of a 1024-channel output
    p = conv.conv_plan(32, 4096, 1024, 4, 4, True, 132)
    assert p.pos_tiles * p.co_tiles == 64 and p.splits == 4
    # its forward fills one wave alone
    assert conv.conv_plan(32, 1024, 4096, 4, 4, False, 132).splits == 1
    # a 32-channel layer's weight gradient over a million positions
    q = conv.wgrad_plan(64, 32, 32, 128, 128, 132)
    assert q.co_tiles * q.ci_tiles == 2 and q.splits > 100
    assert conv._splits(300, 132, 10) == 1 and conv._splits(128, 132, 1) == 1
    assert conv._splits(32, 132, 64) == 4


def _wavefronts(addresses):
    """Shared-memory wavefronts one warp's 4-byte reads take: the most
    distinct addresses on one of the 32 banks."""
    banks = {}
    for a in set(addresses):
        banks[a % 32] = banks.get(a % 32, 0) + 1
    return max(banks.values())


def _offsets(ti, th, tw, slots):
    """Each slot's offset in a halo of (th + 2) x (tw + 2) planes."""
    rs, pl = tw + 2, (th + 2) * (tw + 2)
    return [(p // (th * tw)) * pl + (p % (th * tw) // tw) * rs + p % tw
            for p in range(min(slots, ti * th * tw))]


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_strides_spread_a_warps_reads_over_the_banks(shape):
    n, cin, cout, h, w = shape
    taps = [(t // 3, t % 3) for t in range(conv.TAPS)]
    for flip in (False, True):
        ci, co = (cout, cin) if flip else (cin, cout)
        p = conv.conv_plan(n, ci, co, h, w, flip, 132)
        offs = _offsets(p.ti, p.th, p.tw, conv.CONV_SLOTS)
        # A: lanes (r, c) at channel c (and c + 4), slot p0 + r, each tap;
        # two wavefronts where 8 slots wrap onto a new row of the halo
        rs = p.tw + 2
        worst = max(_wavefronts([c * p.cs + offs[p0 + r] + dr * rs + ds
                                 for r in range(8) for c in range(4)])
                    for p0 in range(0, len(offs) - 7, 8) for dr, ds in taps)
        assert worst <= (1 if p.tw >= 8 else 2), (flip, worst)
        # the weight's split reads: 8 rows of the staged weight at 4 columns
        # 9 apart (under flip, 4 rows at 8 column groups)
        for t in range(conv.TAPS):
            reads = ([c * p.sb + r * conv.TAPS + t for r in range(8) for c in range(4)] if flip
                     else [r * p.sb + c * conv.TAPS + t for r in range(8) for c in range(4)])
            assert _wavefronts(reads) == 1
    q = conv.wgrad_plan(n, cin, cout, h, w, 132)
    offs = _offsets(q.ti, q.th, q.tw, conv.WGRAD_SLOTS)
    rs = q.tw + 2
    # B: lanes (r, c) at input channel r, slot 8 ks + c (+ 4), each tap
    for ks in range(len(offs) // 8):
        for half in (0, 4):
            for dr, ds in taps:
                reads = [r * q.cs + offs[8 * ks + c + half] + dr * rs + ds
                         for r in range(8) for c in range(4)]
                assert _wavefronts(reads) <= (1 if q.tw >= 4 else 2)


def test_resident_blocks_follow_shared_memory():
    assert conv._resident(2, 90_000) == 2
    assert conv._resident(2, 120_000) == 1
    assert conv._resident(4, 34_560) == 4 and conv._resident(4, 60_000) == 3
    assert conv._resident(1, 10_000) == 1
