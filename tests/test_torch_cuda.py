"""txt2vid_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skips where there is no CUDA device. Imports no JAX, so it runs
on a machine with only PyTorch; there, skip the suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 max|diff| <= 1e-4 * max(1, max|ref|) (summation order);
bfloat16 o and the backward's gradients 1e-2 (rounded to bf16 on store), lse
1e-4 (f32 from the same inputs); against float64, a mean error toward zero of
1e-6 to 2e-6 of the mean |ref| by shape; the backward from the kernels' own
forward no further from float64 (RMS) than 2x the plain versions' path in
each gradient float32 holds.
"""

import pytest
import torch

from txt2vid_tpu_torch.ops.attention import attention_core_auto, no_kernel
from txt2vid_tpu_torch.ops.fused_attention import (
    attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq,
    attention_bwd_dq_reference, attention_delta, fused_attention,
    fused_attention_reference)

pytestmark = pytest.mark.cuda

# (B, N, M, d, dv): both instantiations, tiles that do not divide N or M, the
# generator's up1 attention at serving batch 8, and the discriminator's
# Attention3d at the training pyramid's smallest and largest scales (4 keys
# against a 64-row tile; 256 queries in 4 splits of N, K2's keys split 4
# ways), a shape where K2 splits 3 chunks of keys 2 ways, and the cond-128
# generator's Attention(64) width (8, 32), tiles dividing and ragged
SHAPES = [(2, 64, 16, 4, 16), (2, 90, 22, 4, 16), (1, 48, 12, 16, 64),
          (2, 45, 15, 16, 64), (3, 1000, 250, 4, 16), (128, 1024, 256, 4, 16),
          (40, 16, 4, 16, 64), (5, 256, 64, 16, 64), (2, 100, 40, 16, 64),
          (2, 64, 16, 8, 32), (3, 1000, 250, 8, 32)]
TRAIN_SHAPE = (40, 1024, 256, 4, 16)
# the cond-128 generator's up0 attention in training at batch 32 (and serving
# at batch 8)
COND128_SHAPE = (256, 4096, 1024, 8, 32)


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _inputs(shape, dtype, seed=0):
    b, n, m, d, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(2 * torch.randn(size, generator=gen, device="cuda")).to(dtype)
            for size in ((b, n, d), (b, m, d), (b, m, dv))]


def _assert_close(ref, got, tol):
    ref, got = ref.float(), got.float()
    scale = max(1.0, float(ref.abs().max()))
    assert float((ref - got).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(shape, dtype):
    theta, phi, g = _inputs(shape, dtype)
    before = fused_attention.launches
    o, lse = fused_attention(theta, phi, g, return_lse=True)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    ref_o, ref_lse = fused_attention_reference(theta, phi, g, return_lse=True)
    _assert_close(ref_o, o, 1e-4 if dtype == torch.float32 else 1e-2)
    _assert_close(ref_lse, lse, 1e-4)


def test_dispatch_on_cuda():
    theta, phi, g = _inputs(SHAPES[0], torch.float32)
    before = fused_attention.launches
    with no_kernel():
        attention_core_auto(theta, phi, g)
    attention_core_auto(theta, phi, g, use_kernel=False)
    assert fused_attention.launches == before
    attention_core_auto(theta, phi, g)
    assert fused_attention.launches == before + 1


def test_unsupported_pair_raises_on_cuda():
    theta, phi, _ = _inputs(SHAPES[0], torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        fused_attention(theta, phi, torch.zeros(2, 16, 8, device="cuda"))


def _bwd_inputs(shape, dtype, seed=1):
    """Forward inputs, o and lse from the kernel, and a random do."""
    theta, phi, g = _inputs(shape, dtype, seed)
    o, lse = fused_attention(theta, phi, g, return_lse=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    return theta, phi, g, do, lse, attention_delta(o, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_kernels_match_plain(shape, dtype):
    args = _bwd_inputs(shape, dtype)
    before = (attention_bwd_dq.launches, attention_bwd_dkv.launches)
    dtheta = attention_bwd_dq(*args)
    dphi, dg = attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (attention_bwd_dq.launches, attention_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    assert dtheta.dtype == dphi.dtype == dg.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    _assert_close(attention_bwd_dq_reference(*args), dtheta, tol)
    ref_dphi, ref_dg = attention_bwd_dkv_reference(*args)
    _assert_close(ref_dphi, dphi, tol)
    _assert_close(ref_dg, dg, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkv_repeats_bit_for_bit(dtype):
    # the training shape cuts N into splits, summed in a fixed order
    args = _bwd_inputs(TRAIN_SHAPE, dtype)
    first = attention_bwd_dkv(*args)
    again = attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [TRAIN_SHAPE, (5, 256, 64, 16, 64)])
def test_dq_repeats_bit_for_bit(shape, dtype):
    # the second shape splits each query tile's keys across 4 warps, whose
    # partial sums are added in a fixed order
    args = _bwd_inputs(shape, dtype)
    first = attention_bwd_dq(*args)
    again = attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_function_gradients_match_plain_path(shape):
    theta, phi, g = (t.requires_grad_() for t in _inputs(shape, torch.float32, 3))
    w = torch.randn(shape[0], shape[1], shape[4], device="cuda")
    before = (fused_attention.launches, attention_bwd_dq.launches)
    o = attention_core_auto(theta, phi, g)
    grads = torch.autograd.grad((o * w).sum(), (theta, phi, g))
    assert (fused_attention.launches, attention_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    with no_kernel():
        plain = torch.autograd.grad((attention_core_auto(theta, phi, g) * w).sum(),
                                    (theta, phi, g))
    for ref, got in zip(plain, grads):
        _assert_close(ref, got, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_repeats_bit_for_bit_at_the_cond128_shape(dtype):
    args = _bwd_inputs(COND128_SHAPE, dtype)
    first = (attention_bwd_dq(*args), *attention_bwd_dkv(*args))
    again = (attention_bwd_dq(*args), *attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


# (shape, limit): each limit lies above the largest drift of the kernels that
# add each chunk's product with rounding and below the smallest of the
# kernels that kept their sums in MMA fragments (chip_smoke.py's BIAS_TOL)
@pytest.mark.parametrize("shape,tol", [((2, 4096, 1024, 8, 32), 2e-6),
                                       ((4, 1024, 256, 4, 16), 1e-6),
                                       ((2, 2048, 512, 16, 64), 2e-6)])
def test_kernels_do_not_drift_toward_zero(shape, tol):
    # the tensor cores' adds truncate: a sum kept in MMA fragments over 1024
    # keys fell 5e-6 short of float64 on average, the plain float32 versions
    # about 1e-8; the kernels add each chunk's product with rounding, which
    # keeps 3e-7 to 1.2e-6
    b, n, m, d, dv = shape
    # unit-scale inputs (logits of standard deviation sqrt(d)), as
    # chip_smoke.py's float64 phase holds: the cond-128 discriminator's logits
    # sit near 0.35 in a step, under d = 16's 4 here. The next test holds
    # twice this scale
    _assert_no_drift(shape, tol, 0.5)


@pytest.mark.parametrize("shape", [(2, 4096, 1024, 8, 32), (4, 1024, 256, 4, 16),
                                   (2, 2048, 512, 16, 64)])
def test_kernels_do_not_drift_toward_zero_at_the_unscaled_inputs(shape):
    # _inputs as they are: twice unit scale, logits of standard deviation
    # 4 sqrt(d). The TF32 passes of S = theta phi^T, added in one
    # accumulator, truncated the logits at their own magnitude, and against
    # float64's lse (not K1's, whose own truncation cancelled it) K2 and K3
    # at d = 16 drifted 4.25e-6 toward zero; with each group of passes summed
    # from zero and added rounding to nearest, 1.85e-6
    _assert_no_drift(shape, 2e-6, 1.0)


def _assert_no_drift(shape, tol, scale):
    """K1-K3's mean error toward zero against float64, the backward from
    float64's o and lse, at most `tol` of the mean |float64| in each output."""
    b, n, m, d, dv = shape
    theta, phi, g = (scale * x for x in _inputs(shape, torch.float32, 6))
    do = torch.randn(b, n, dv, device="cuda")
    o, lse, *grads = _float64_attention(theta, phi, g, do)
    args = (theta, phi, g, do, lse.float(), attention_delta(o.float(), do))
    got = (fused_attention(theta, phi, g), attention_bwd_dq(*args), *attention_bwd_dkv(*args))
    for ref, x in zip((o, *grads), got):
        bias = float(((x.double() - ref) * ref.sign()).mean() / ref.abs().mean())
        assert abs(bias) <= tol


def _float64_attention(theta, phi, g, do):
    """o, lse, dtheta, dphi, dg in float64."""
    t, f, v, o_ = (x.double() for x in (theta, phi, g, do))
    s = t @ f.transpose(1, 2)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = p @ v
    ds = p * (o_ @ v.transpose(1, 2) - (o_ * o).sum(-1)[..., None])
    return o, lse, ds @ f, ds.transpose(1, 2) @ t, p.transpose(1, 2) @ o_


# (shape, input scale): the cond-128 generator's width at the logits' scale
# its up0 shows at the seed's weights (standard deviation near 7e3), and
# d = 16 at twice unit scale
@pytest.mark.parametrize("shape,scale", [((4, 4096, 1024, 8, 32), 50),
                                         ((2, 2048, 512, 16, 64), 2)])
def test_backward_from_its_own_forward_keeps_the_plain_accuracy(shape, scale):
    # K2 and K3 form p = exp(s - lse) before scaling by log2 e, and K1 its
    # p = exp(s - max): with lse * log2 e rounded first, dg from K1's lse
    # strayed 182x further from float64 than the plain path at x50. Held: each
    # gradient that float32 holds (the plain path within 1e-4 RMS of float64;
    # at x50 dtheta and dphi are the difference of rounded dot products), as
    # chip_smoke.py's OWN_RMS_TOL and WELL_CONDITIONED
    b, n, m, d, dv = shape
    theta, phi, g = (x * scale / 2 for x in _inputs(shape, torch.float32, 7))
    do = torch.randn(b, n, dv, device="cuda")
    refs = _float64_attention(theta, phi, g, do)[2:]

    def path(fwd, dq, dkv):
        o, lse = fwd(theta, phi, g, return_lse=True)
        args = (theta, phi, g, do, lse, attention_delta(o, do))
        return dq(*args), *dkv(*args)

    def rms(ref, x):
        return float((x.double() - ref).square().mean().sqrt() / ref.square().mean().sqrt())

    kernels = path(fused_attention, attention_bwd_dq, attention_bwd_dkv)
    plain = path(fused_attention_reference, attention_bwd_dq_reference,
                 attention_bwd_dkv_reference)
    held = [(rms(ref, k), rms(ref, p)) for ref, k, p in zip(refs, kernels, plain)
            if rms(ref, p) <= 1e-4]
    assert held and all(k <= 2 * p for k, p in held)


def test_function_gradients_at_width_8_32():
    shape = (2, 90, 22, 8, 32)
    theta, phi, g = (t.requires_grad_() for t in _inputs(shape, torch.float32, 5))
    w = torch.randn(shape[0], shape[1], shape[4], device="cuda")
    before = (fused_attention.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches)
    o = attention_core_auto(theta, phi, g)
    grads = torch.autograd.grad((o * w).sum(), (theta, phi, g))
    assert (fused_attention.launches, attention_bwd_dq.launches, attention_bwd_dkv.launches) \
        == tuple(x + 1 for x in before)
    with no_kernel():
        plain = torch.autograd.grad((attention_core_auto(theta, phi, g) * w).sum(),
                                    (theta, phi, g))
    for ref, got in zip(plain, grads):
        _assert_close(ref, got, 1e-4)


def test_bf16_function_gradients():
    theta, phi, g = (t.requires_grad_() for t in _inputs(SHAPES[2], torch.bfloat16, 4))
    o = attention_core_auto(theta, phi, g)
    grads = torch.autograd.grad(o.float().square().sum(), (theta, phi, g))
    t32 = [t.detach().float().requires_grad_() for t in (theta, phi, g)]
    with no_kernel():
        plain = torch.autograd.grad(attention_core_auto(*t32).square().sum(), t32)
    for ref, got in zip(plain, grads):
        assert got.dtype == torch.bfloat16
        _assert_close(ref, got, 1e-2)
