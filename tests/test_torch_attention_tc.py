"""The numerics and geometry of the tensor-core attention kernels (K1, K2 and
K3), checked on the CPU.

- Three TF32 passes: a numpy emulation of the kernels' split (hi rounded to
  TF32 to nearest, lo = x - hi truncated to TF32) and products shows that three
  passes stay within the card tests' 1e-4 * max(1, max|ref|) of the plain
  float32 versions at their logit scale (2 * randn, d = 16, dv = 64, and the
  cond-128 generator's d = 8, dv = 32), and that one pass does not.
- (d, dv) = (8, 32): the plain versions of K1, K2 and K3 against the Pallas
  kernels in interpret mode, float32 (2e-5 * scale) and bfloat16 inputs (as
  below).
- bfloat16: the plain versions of K1, K2 and K3, which round p and ds to bf16
  before their products as the TPU kernels do, against the JAX package's
  Pallas kernels in interpret mode with bf16 inputs and small blocks. o and
  the gradients 1e-2 * scale (each side rounds to bf16 in its own place: p
  relative to the running max there, the final one here); lse 1e-4 * scale
  (f32 logits of bf16 inputs summed in another order); K2's dtheta alone 1e-4
  * scale (the same roundings on both sides, f32 sums in another order).
- Truncating accumulation: an emulation of the tensor cores' adds shows the
  bias a sum kept in MMA fragments over a long loop takes, and that summing
  each chunk from zero, as the kernels do, removes most of it.
- K3's split of N across blocks covers every query row exactly once, K2's
  split of M among a query tile's warps every key of every tile exactly once,
  and the kernels refuse data that does not start on a 16-byte boundary; at
  the cond-128 shape (256, 4096, 1024) neither splits on 114 or 132 SMs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ops import assert_close
from txt2vid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from txt2vid_tpu.ops.pallas_attention import fused_attention_bwd as jax_fused_attention_bwd
from txt2vid_tpu_torch.ops import fused_attention as port_fused


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = 1e-4


def tf32_split(x):
    """The kernels' (hi, lo) of float32 x, as float32 arrays of TF32 values."""
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = ((x - hi).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi, lo


def mm(a, b, passes):
    """Batched a @ b as the kernels form it: TF32 operands, products exact,
    sums in float32; three passes lo*hi + hi*lo + hi*hi, or one pass hi*hi."""
    a_hi, a_lo = tf32_split(np.ascontiguousarray(a, np.float32))
    b_hi, b_lo = tf32_split(np.ascontiguousarray(b, np.float32))
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulated_forward(theta, phi, g, passes, pg_passes=None):
    """(o, lse) with `passes` for theta phi^T and `pg_passes` (default the
    same) for p g."""
    s = mm(theta, phi.transpose(0, 2, 1), passes)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    return mm(p, g, pg_passes or passes) / l, (m + np.log(l))[..., 0]


def emulated_dq(theta, phi, g, do, lse, delta, passes):
    p = np.exp(mm(theta, phi.transpose(0, 2, 1), passes) - lse[..., None])
    ds = p * (mm(do, g.transpose(0, 2, 1), passes) - delta[..., None])
    return (mm(ds, phi, passes),)


def emulated_dkv(theta, phi, g, do, lse, delta, passes):
    p = np.exp(mm(phi, theta.transpose(0, 2, 1), passes) - lse[:, None, :])   # P^T
    dg = mm(p, do, passes)
    ds = p * (mm(g, do.transpose(0, 2, 1), passes) - delta[:, None, :])
    return mm(ds, theta, passes), dg


def _card_inputs(seed, b=2, n=128, m=32, d=16, dv=64):
    """The card tests' inputs: theta, phi, g as 2 * randn, do as randn."""
    rng = np.random.default_rng(seed)
    theta, phi = ((2 * rng.standard_normal((b, k, d))).astype(np.float32) for k in (n, m))
    g = (2 * rng.standard_normal((b, m, dv))).astype(np.float32)
    do = rng.standard_normal((b, n, dv)).astype(np.float32)
    return theta, phi, g, do


def _err(ref, got):
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
    return float(np.abs(ref - got).max()) / max(1.0, float(np.abs(ref).max()))


def _check_tf32_passes(direction, d=16, dv=64):
    theta, phi, g, do = _card_inputs(20, d=d, dv=dv)
    t = [torch.from_numpy(a) for a in (theta, phi, g, do)]
    o, lse = port_fused.fused_attention_reference(*t[:3], return_lse=True)
    if direction == "forward":
        refs = (o, lse)
        got = {p: emulated_forward(theta, phi, g, p) for p in (1, 3)}
        # p g alone in one pass is off too, by less
        assert _err(o, emulated_forward(theta, phi, g, 3, pg_passes=1)[0]) > TOL
    else:
        delta = port_fused.attention_delta(o, t[3])
        plain, emulated = {"dq": (port_fused.attention_bwd_dq_reference, emulated_dq),
                           "dkv": (port_fused.attention_bwd_dkv_reference, emulated_dkv)
                           }[direction]
        refs = plain(*t, lse, delta)
        refs = refs if isinstance(refs, tuple) else (refs,)
        got = {p: emulated(theta, phi, g, do, lse.numpy(), delta.numpy(), p)
               for p in (1, 3)}
    errs = {p: [_err(r, x) for r, x in zip(refs, outs)] for p, outs in got.items()}
    assert max(errs[3]) <= TOL, errs
    assert errs[1][0] > TOL, errs


@pytest.mark.parametrize("direction", ["forward", "dq", "dkv"])
def test_three_tf32_passes_keep_float32_accuracy_and_one_does_not(direction):
    _check_tf32_passes(direction)


@pytest.mark.parametrize("direction", ["forward", "dq", "dkv"])
def test_three_tf32_passes_at_d8(direction):
    # the cond-128 generator's Attention(64): d = 8 is one TF32 MMA step, no
    # zero padding
    _check_tf32_passes(direction, d=8, dv=32)


def _round_toward_zero(x):
    """float64 -> float32, truncated toward zero."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_a_chunk_summed_from_zero_keeps_truncating_adds_unbiased():
    """The tensor cores add an MMA's products into its accumulator with
    truncation toward zero. Emulated with exact products of 8 keys per MMA
    step: a sum over 1024 keys kept in one MMA accumulator falls short of
    float64 by about 3e-6 on average (K1-K3 on an H100 showed 5e-6 when they
    summed so), while
    summing each 16-key chunk from zero and adding it in float32 (rounded to
    nearest), as the kernels do, leaves under a tenth of that bias."""
    rng = np.random.default_rng(30)
    n, m = 2048, 1024
    p = np.exp(rng.standard_normal((n, m))).astype(np.float32)
    g = rng.standard_normal(m).astype(np.float32)
    ref = p.astype(np.float64) @ g.astype(np.float64)

    def mma_sum(chunk):
        acc = np.zeros(n, np.float32)
        for c0 in range(0, m, chunk):
            t = np.zeros(n, np.float32)
            for k0 in range(c0, c0 + chunk, 8):
                t = _round_toward_zero(t.astype(np.float64) + p[:, k0:k0 + 8].astype(np.float64)
                                       @ g[k0:k0 + 8].astype(np.float64))
            acc = t if chunk == m else acc + t
        return acc

    def bias(x):
        return float(np.mean((x - ref) * np.sign(ref)) / np.mean(np.abs(ref)))

    one, chunked = bias(mma_sum(m)), bias(mma_sum(16))
    assert one < -1e-6
    assert abs(chunked) < abs(one) / 10
    assert abs(bias(p @ g)) < abs(one) / 10         # float32 rounded to nearest


# (B, N, M, d, dv): both instantiations, and a shape no block divides evenly
BF16_SHAPES = [(2, 64, 16, 4, 16), (2, 48, 12, 16, 64)]


def _bf16(*arrays):
    """numpy f32 -> (jnp bf16, torch bf16) holding the same values."""
    out = []
    for a in arrays:
        x = jnp.asarray(a).astype(jnp.bfloat16)
        out.append((x, torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()))
    return out


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_plain_forward_matches_pallas_interpret(shape):
    theta, phi, g, _ = _card_inputs(21, *shape)
    (jt, tt), (jp, tp), (jg, tg) = _bf16(theta, phi, g)
    o_ref, lse_ref = jax_fused_attention(jt, jp, jg, block_n=16, block_m=8,
                                         interpret=True, return_lse=True)
    o, lse = port_fused.fused_attention_reference(tt, tp, tg, return_lse=True)
    assert o.dtype == torch.bfloat16 and o_ref.dtype == jnp.bfloat16
    assert_close(np.asarray(o_ref.astype(jnp.float32)), o.float(), 1e-2, "o")
    assert_close(np.asarray(lse_ref), lse, 1e-4, "lse")


@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_plain_backward_matches_pallas_interpret(shape):
    theta, phi, g, do = _card_inputs(22, *shape)
    (jt, tt), (jp, tp), (jg, tg), (jdo, tdo) = _bf16(theta, phi, g, do)
    o, lse = jax_fused_attention(jt, jp, jg, block_n=16, block_m=8, interpret=True,
                                 return_lse=True)
    refs = jax_fused_attention_bwd(jt, jp, jg, o, lse, jdo, block_n=16, block_m=8,
                                   interpret=True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    got = port_fused.fused_attention_bwd_reference(tt, tp, tg, to,
                                                   torch.from_numpy(np.array(lse)), tdo)
    for what, ref, x in zip(("dtheta", "dphi", "dg"), refs, got):
        assert x.dtype == torch.bfloat16, what
        assert_close(np.asarray(ref.astype(jnp.float32)), x.float(), 1e-2, what)


@pytest.mark.parametrize("shape", [*BF16_SHAPES, (2, 256, 64, 16, 64)])
def test_bf16_plain_dq_rounds_ds_as_pallas_does(shape):
    # K2's plain version rounds ds to bf16 before ds @ phi, as the TPU kernel
    # does; the two then differ only in f32 summation order, far below bf16's
    # 4e-3 rounding of dtheta
    theta, phi, g, do = _card_inputs(22, *shape)
    (jt, tt), (jp, tp), (jg, tg), (jdo, tdo) = _bf16(theta, phi, g, do)
    o, lse = jax_fused_attention(jt, jp, jg, block_n=16, block_m=8, interpret=True,
                                 return_lse=True)
    ref = jax_fused_attention_bwd(jt, jp, jg, o, lse, jdo, block_n=16, block_m=8,
                                  interpret=True)[0]
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).bfloat16()
    tl = torch.from_numpy(np.array(lse))
    got = port_fused.attention_bwd_dq_reference(tt, tp, tg, tdo, tl,
                                                port_fused.attention_delta(to, tdo))
    assert got.dtype == torch.bfloat16
    assert_close(np.asarray(ref.astype(jnp.float32)), got.float(), 1e-4, "dtheta")


# (B, N, M, d, dv) at the cond-128 generator's width: tiles that divide, and
# N, M that neither the kernels' tiles nor the Pallas blocks divide evenly
WIDTH_8_32 = [(2, 64, 16, 8, 32), (2, 90, 22, 8, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDTH_8_32)
def test_width_8_32_plain_matches_pallas_interpret(shape, dtype):
    """K1, K2 and K3's plain versions at (d, dv) = (8, 32) against the Pallas
    kernels in interpret mode: float32 2e-5 * scale (summation order);
    bfloat16 inputs 1e-2 * scale for o and the gradients, 1e-4 for lse."""
    theta, phi, g, do = _card_inputs(23, *shape)
    if dtype == "float32":
        (jt, tt), (jp, tp), (jg, tg), (jdo, tdo) = (
            (jnp.asarray(a), torch.from_numpy(a)) for a in (theta, phi, g, do))
        tol = lse_tol = 2e-5
    else:
        (jt, tt), (jp, tp), (jg, tg), (jdo, tdo) = _bf16(theta, phi, g, do)
        tol, lse_tol = 1e-2, 1e-4
    o_ref, lse_ref = jax_fused_attention(jt, jp, jg, block_n=16, block_m=8, interpret=True,
                                         return_lse=True)
    o, lse = port_fused.fused_attention_reference(tt, tp, tg, return_lse=True)
    assert o.dtype == getattr(torch, dtype)
    assert_close(np.asarray(o_ref.astype(jnp.float32)), o.float(), tol, "o")
    assert_close(np.asarray(lse_ref), lse, lse_tol, "lse")
    refs = jax_fused_attention_bwd(jt, jp, jg, o_ref, lse_ref, jdo, block_n=16, block_m=8,
                                   interpret=True)
    to = torch.from_numpy(np.array(o_ref.astype(jnp.float32))).to(o.dtype)
    got = port_fused.fused_attention_bwd_reference(tt, tp, tg, to,
                                                   torch.from_numpy(np.array(lse_ref)), tdo)
    for what, ref, x in zip(("dtheta", "dphi", "dg"), refs, got):
        assert x.dtype == o.dtype, what
        assert_close(np.asarray(ref.astype(jnp.float32)), x.float(), tol, what)


@pytest.mark.parametrize("sms", [114, 132])
def test_splits_at_the_cond128_generator_shape(sms):
    # (B, N, M) = (256, 4096, 1024): 16384 K2 blocks and 4096 K3 blocks fill
    # an H100 (PCIe 114 SMs, SXM 132) without splitting
    assert port_fused.dq_splits(256, 4096, 1024, sms) == 1
    assert port_fused.dkv_splits(256, 4096, 1024, sms) == (1, 4096)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("shape", chip_smoke.ATTENTION_SHAPES)
def test_dkv_splits_cover_every_query_row_once(shape, sms):
    b, n, m = shape[:3]
    splits, rows = port_fused.dkv_splits(b, n, m, sms)
    assert 1 <= splits <= 65535 and rows % 64 == 0
    covered = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        assert lo < hi, f"split {s} of {splits} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("shape", chip_smoke.ATTENTION_SHAPES)
def test_dq_splits_cover_every_key_of_every_query_tile_once(shape, sms):
    # K2's geometry: a block of 4 warps holds 4 / splits query tiles of 16
    # rows; warp w is slot w % splits of tile w // splits and takes the 16-key
    # chunks slot, slot + splits, ... of each 64-key stage
    b, n, m = shape[:3]
    splits = port_fused.dq_splits(b, n, m, sms)
    assert splits in (1, 2, 4)
    if shape == chip_smoke.TRAIN_SHAPE and sms > 1:
        assert splits == 1      # the generator's shape keeps K1's layout
    taken = {}                  # first row of a query tile -> times each key is taken
    for x in range(-(-n * splits // 64)):
        for w in range(4):
            slot, row0 = w % splits, (x * (4 // splits) + w // splits) * 16
            if row0 >= n:
                continue
            keys = taken.setdefault(row0, np.zeros(m, np.int64))
            for t0 in range(0, m, 64):
                valid = min(64, m - t0)
                for k0 in range(slot * 16, valid, splits * 16):
                    keys[t0 + k0:t0 + min(k0 + 16, valid)] += 1
    assert sorted(taken) == list(range(0, n, 16))
    assert all((keys == 1).all() for keys in taken.values())


def test_kernels_refuse_data_off_a_16_byte_boundary():
    # cp.async copies rows in chunks of up to 16 bytes
    storage = torch.zeros(40)
    port_fused._check_aligned(storage[:16], storage[4:20])
    with pytest.raises(ValueError, match="16-byte boundary"):
        port_fused._check_aligned(storage[:16], storage[1:17])
