"""The training slice's ops in txt2vid_tpu_torch against txt2vid_tpu on the CPU:
the attention backward (K2/K3's plain versions and the autograd Function),
the two repaired dispatch faults, 3-D pooling, the subsample pyramid and the
caption derangement.

Inputs come from seeded numpy generators. The JAX attention runs its Pallas
kernels in interpret mode with small blocks, so several blocks accumulate.
Tolerances: the attention backward 2e-5 * max(1, max|ref|) (f32 logits summed
in another order); the plain forward at a width no kernel takes 1e-5 * scale;
pooling, subsampling and the derangement 1e-6 (they move or average the same
numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import pallas_interpret
from test_torch_ops import _attention_inputs, assert_close
from txt2vid_tpu.ops import attention as jax_attention
from txt2vid_tpu.ops import pooling as jax_pooling
from txt2vid_tpu.ops import subsample as jax_subsample
from txt2vid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from txt2vid_tpu.ops.pallas_attention import fused_attention_bwd as jax_fused_attention_bwd
from txt2vid_tpu.utils import misc as jax_misc
from txt2vid_tpu_torch.ops import attention as port_attention
from txt2vid_tpu_torch.ops import fused_attention as port_fused
from txt2vid_tpu_torch.ops import pooling as port_pooling
from txt2vid_tpu_torch.ops import subsample as port_subsample
from txt2vid_tpu_torch.utils.misc import gen_perm_device

# (B, N, M, d, dv): both instantiations and a ragged shape
BWD_SHAPES = [(2, 64, 16, 4, 16), (1, 64, 16, 16, 64), (2, 90, 22, 16, 64)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a, order="C")) for a in arrays]


class TestAttentionBackward:
    @pytest.mark.parametrize("shape", BWD_SHAPES)
    def test_reference_matches_pallas_bwd_interpret(self, shape):
        theta, phi, g = _attention_inputs(20, *shape, logit_scale=2.0)
        do = np.random.default_rng(21).standard_normal(shape[:2] + shape[4:]).astype(np.float32)
        o, lse = jax_fused_attention(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(g),
                                     block_n=16, block_m=8, interpret=True, return_lse=True)
        ref = jax_fused_attention_bwd(jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(g),
                                      o, lse, jnp.asarray(do), block_n=16, block_m=8,
                                      interpret=True)
        got = port_fused.fused_attention_bwd_reference(
            *_t(theta, phi, g, np.asarray(o), np.asarray(lse), do))
        for what, r, p in zip(("dtheta", "dphi", "dg"), ref, got):
            assert p.dtype == torch.float32
            assert_close(r, p, 2e-5, what)

    @pytest.mark.parametrize("shape", BWD_SHAPES)
    def test_function_gradients_match_jax_grad(self, shape):
        theta, phi, g = _attention_inputs(22, *shape, logit_scale=2.0)
        w = np.random.default_rng(23).standard_normal(shape[:2] + shape[4:]).astype(np.float32)

        def loss(t, p, v):
            return jnp.sum(jax_attention.attention_core_fused(t, p, v) * w)

        with pallas_interpret():
            ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(g))
        inputs = [t.requires_grad_() for t in _t(theta, phi, g)]
        o = port_attention.attention_core_auto(*inputs)
        assert type(o.grad_fn).__name__ == "FusedAttentionBackward"
        got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), inputs)
        for what, r, p in zip(("dtheta", "dphi", "dg"), ref, got):
            assert_close(r, p, 2e-5, what)

    def test_double_backward_raises(self):
        theta, phi, g = (t.requires_grad_() for t in _t(*_attention_inputs(24, 1, 16, 4, 4, 16)))
        w = torch.randn(1, 16, 16, requires_grad=True)
        o = port_attention.attention_core_auto(theta, phi, g)
        with pytest.raises(RuntimeError, match="second-order"):
            torch.autograd.grad((o * w).sum(), theta, create_graph=True)
        # without create_graph the first-order gradient is there
        (dtheta,) = torch.autograd.grad((o * w).sum(), theta)
        assert dtheta.shape == theta.shape

    def test_forward_asks_for_lse_only_when_a_gradient_is_needed(self, monkeypatch):
        asked = []

        def recording(theta, phi, g, return_lse=False):
            asked.append(return_lse)
            return port_fused.fused_attention(theta, phi, g, return_lse)

        monkeypatch.setattr(port_attention, "fused_attention", recording)
        theta, phi, g = _t(*_attention_inputs(25, 1, 16, 4, 4, 16))
        port_attention.attention_core_auto(theta, phi, g)
        port_attention.attention_core_auto(theta.requires_grad_(), phi, g)
        with torch.no_grad():
            port_attention.attention_core_auto(theta, phi, g)
        assert asked == [False, True, False]


class TestRepairedDispatch:
    def test_cpu_tensors_take_the_plain_path_at_any_width(self):
        """CPU tensors at a (d, dv) that no kernel is built for: the plain
        result, as the JAX package's attention_core_auto gives on the CPU."""
        shape = (2, 64, 16, 2, 8)
        theta, phi, g = _attention_inputs(26, *shape)
        ref = jax_attention.attention_core_auto(jnp.asarray(theta), jnp.asarray(phi),
                                                jnp.asarray(g))
        got = port_attention.attention_core_auto(*_t(theta, phi, g))
        assert_close(ref, got, 1e-5, "attention_core_auto (2, 8)")
        o, lse = port_fused.fused_attention(*_t(theta, phi, g), return_lse=True)
        assert o.shape == (2, 64, 8) and lse.shape == (2, 64)

    def test_gradients_flow_from_a_kernel_output_without_graph(self, monkeypatch):
        """The kernels fill tensors through ctypes, so their outputs carry no
        autograd graph. Stand one in with the plain version computed without
        a graph: the Function still gives the plain path's gradients."""
        def graphless(theta, phi, g, return_lse=False):
            with torch.no_grad():
                return port_fused.fused_attention_reference(theta, phi, g, return_lse)

        monkeypatch.setattr(port_attention, "fused_attention", graphless)
        theta, phi, g = (t.requires_grad_() for t in _t(*_attention_inputs(27, 2, 64, 16, 4, 16)))
        w = torch.randn(2, 64, 16)
        got = torch.autograd.grad((port_attention.attention_core_auto(theta, phi, g) * w).sum(),
                                  (theta, phi, g))
        ref = torch.autograd.grad((port_attention.attention_core(theta, phi, g) * w).sum(),
                                  (theta, phi, g))
        for r, p in zip(ref, got):
            assert float(p.abs().max()) > 0
            assert_close(r.numpy(), p, 2e-5)


def _to_ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


class TestPooling3d:
    @pytest.mark.parametrize("shape", [(2, 4, 6, 8, 3), (2, 5, 7, 1, 3), (1, 1, 2, 3, 4),
                                       (1, 1, 1, 1, 2)])
    def test_avg_pool_3d_shape_aware(self, shape):
        x = np.random.default_rng(30).standard_normal(shape).astype(np.float32)
        ref = jax_pooling.avg_pool_3d_shape_aware(jnp.asarray(x))
        got = port_pooling.avg_pool_3d_shape_aware(_to_ncdhw(x)).permute(0, 2, 3, 4, 1)
        assert_close(ref, got, 1e-6, "avg_pool_3d_shape_aware")

    def test_max_pool_3d(self):
        x = np.random.default_rng(31).standard_normal((2, 3, 4, 6, 5)).astype(np.float32)
        ref = jax_pooling.max_pool_3d(jnp.asarray(x))
        got = port_pooling.max_pool_3d(_to_ncdhw(x)).permute(0, 2, 3, 4, 1)
        assert_close(ref, got, 1e-6, "max_pool_3d")


def _key_with_phase(bt):
    """A key for which the JAX subsample draws phase bt."""
    for seed in range(100):
        key = jax.random.key(seed)
        if int(jax.random.randint(key, (), 0, 2)) == bt:
            return key
    raise AssertionError(bt)


class TestSubsample:
    @pytest.mark.parametrize("bt", [0, 1])
    def test_subsample_video(self, bt):
        x = np.random.default_rng(32).standard_normal((5, 8, 3, 2, 2)).astype(np.float32)
        ref, ref_bt = jax_subsample.subsample_video(jnp.asarray(x), _key_with_phase(bt))
        assert int(ref_bt) == bt
        got = port_subsample.subsample_video(torch.from_numpy(x), bt)
        assert got.shape == (3, 4, 3, 2, 2)
        assert_close(ref, got, 1e-6, "subsample_video")

    @pytest.mark.parametrize("size_in,size_out", [(64, 8), (10, 4), (12, 5)])
    def test_resize_is_nearest_exact(self, size_in, size_out):
        x = np.random.default_rng(33).standard_normal(
            (2, 3, size_in, size_in, 3)).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(x), (2, 3, size_out, size_out, 3), "nearest")
        got = port_subsample.resize_nearest(torch.from_numpy(x), size_out)
        assert_close(ref, got, 1e-6, "resize")
        if size_in % size_out:
            # torch's default "nearest" samples floor(i * in / out): other pixels
            frames = torch.from_numpy(x).reshape(6, size_in, size_in, 3).permute(0, 3, 1, 2)
            other = F.interpolate(frames, size=(size_out, size_out), mode="nearest")
            assert not np.allclose(np.asarray(ref).reshape(6, size_out, size_out, 3),
                                   other.permute(0, 2, 3, 1).numpy())

    @pytest.mark.parametrize("subsample_input", [True, False])
    def test_multiscale_pyramid(self, subsample_input, monkeypatch):
        phases, original = [], jax_subsample.subsample_video

        def recording(*args, **kwargs):
            out = original(*args, **kwargs)
            phases.append(int(out[1]))
            return out

        monkeypatch.setattr(jax_subsample, "subsample_video", recording)
        rng = np.random.default_rng(34)
        x = rng.standard_normal((8, 8, 32, 32, 3)).astype(np.float32)
        cond = rng.standard_normal((8, 6)).astype(np.float32)
        xs, conds = jax_subsample.multiscale_pyramid(jnp.asarray(x), jnp.asarray(cond),
                                                     [8, 16, 32], jax.random.key(35),
                                                     subsample_input)
        got_xs, got_conds = port_subsample.multiscale_pyramid(
            torch.from_numpy(x), torch.from_numpy(cond), [8, 16, 32], phases, subsample_input)
        assert len(phases) == (2 if subsample_input else 0)
        for r, p in zip(xs, got_xs):
            assert_close(r, p, 1e-6, "pyramid scale")
        for r, p in zip(conds, got_conds):
            assert_close(r, p, 1e-6, "pyramid cond")
        assert [tuple(p.shape[:2]) for p in got_xs] == (
            [(8, 8), (4, 4), (2, 2)] if subsample_input else [(8, 8)] * 3)


class TestDerangement:
    @pytest.mark.parametrize("n", [2, 5, 40])
    def test_matches_jax_for_the_same_permutation(self, n):
        key = jax.random.key(n)
        ref = np.asarray(jax_misc.gen_perm_device(key, n))
        p = torch.from_numpy(np.array(jax.random.permutation(key, n)))
        got = gen_perm_device(n, p=p)
        np.testing.assert_array_equal(ref, got.numpy())

    @pytest.mark.parametrize("n", [2, 3, 40])
    def test_drawn_permutation_is_one_n_cycle(self, n):
        perm = gen_perm_device(n, generator=torch.Generator().manual_seed(n)).tolist()
        i, seen = 0, []
        for _ in range(n):
            seen.append(i)
            i = perm[i]
        assert i == 0 and sorted(seen) == list(range(n))
        assert all(perm[j] != j for j in range(n))

    def test_batch_of_one_is_the_identity(self):
        assert gen_perm_device(1).tolist() == [0]
