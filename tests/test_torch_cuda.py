"""txt2vid_tpu_torch's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skips where there is no CUDA device. Imports no JAX, so it runs
on a machine with only PyTorch; there, skip the suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: float32 max|diff| <= 1e-4 * max(1, max|ref|) (summation order);
bfloat16 o and the backward's gradients 1e-2 (rounded to bf16 on store), lse
1e-4 (f32 from the same inputs).
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
# ways), and a shape where K2 splits 3 chunks of keys 2 ways
SHAPES = [(2, 64, 16, 4, 16), (2, 90, 22, 4, 16), (1, 48, 12, 16, 64),
          (2, 45, 15, 16, 64), (3, 1000, 250, 4, 16), (128, 1024, 256, 4, 16),
          (40, 16, 4, 16, 64), (5, 256, 64, 16, 64), (2, 100, 40, 16, 64)]
TRAIN_SHAPE = (40, 1024, 256, 4, 16)


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
