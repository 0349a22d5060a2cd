"""txt2vid_tpu_torch.ops against txt2vid_tpu.ops on the CPU.

Inputs come from a seeded numpy generator and go through both the JAX function
and the port's. The JAX side of the fused attention runs the Pallas kernel in
interpret mode with small blocks, so several M blocks exercise its online
softmax. Tolerances: single ops max|diff| <= 1e-5 * max(1, max|ref|); attention
2e-5 * scale, since both sides form f32 logits but sum in different orders.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txt2vid_tpu.ops import attention as jax_attention
from txt2vid_tpu.ops import initializers as jax_init
from txt2vid_tpu.ops import pooling as jax_pooling
from txt2vid_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from txt2vid_tpu_torch.ops import attention as port_attention
from txt2vid_tpu_torch.ops import initializers as port_init
from txt2vid_tpu_torch.ops import pooling as port_pooling
from txt2vid_tpu_torch.ops.fused_attention import (SUPPORTED_DV, _check_kernel,
                                                   fused_attention,
                                                   fused_attention_reference)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(ref, got, tol, what=""):
    ref = np.asarray(ref, np.float64)
    got = (got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got)).astype(np.float64)
    assert ref.shape == got.shape, f"{what}: {ref.shape} vs {got.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def _attention_inputs(seed, b, n, m, d, dv, logit_scale=1.0):
    rng = np.random.default_rng(seed)
    theta = (rng.standard_normal((b, n, d)) * logit_scale).astype(np.float32)
    phi = (rng.standard_normal((b, m, d)) * logit_scale).astype(np.float32)
    g = rng.standard_normal((b, m, dv)).astype(np.float32)
    return theta, phi, g


class TestPooling:
    def test_max_pool_2d(self):
        x = np.random.default_rng(0).standard_normal((2, 8, 6, 5)).astype(np.float32)
        ref = jax_pooling.max_pool_2d(jnp.asarray(x))                      # NHWC
        got = port_pooling.max_pool_2d(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert_close(ref, got.permute(0, 2, 3, 1), 1e-5, "max_pool_2d")

    def test_upsample_nearest_2d(self):
        x = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(np.float32)
        ref = jax_pooling.upsample_nearest_2d(jnp.asarray(x))
        got = port_pooling.upsample_nearest_2d(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert_close(ref, got.permute(0, 2, 3, 1), 1e-5, "upsample_nearest_2d")


class TestInitializers:
    """The port draws its own numbers; the distributions must match the JAX
    package's. Compared as sample standard deviations over many draws (4%: the
    sampling error of a std over >= 20k draws is under 1%)."""

    @staticmethod
    def _std_close(a, b):
        a, b = float(np.std(a)), float(np.std(b))
        assert abs(a - b) <= 0.04 * b, (a, b)

    @pytest.mark.parametrize("gain", [1.0, math.sqrt(2.0)])
    def test_xavier_conv(self, gain):
        ref = jax_init.make_kernel_init("xavier", gain)(jax.random.key(0), (3, 3, 64, 48))
        w = torch.empty(48, 64, 3, 3)
        port_init.xavier_normal_(w, gain, torch.Generator().manual_seed(0))
        self._std_close(w.numpy(), np.asarray(ref))

    def test_fused_gate(self):
        ref = jax_init.fused_gate_init(jax_init.make_kernel_init("xavier"))(
            jax.random.key(1), (3, 3, 32, 4 * 64))
        w = torch.empty(4 * 64, 32, 3, 3)
        port_init.fused_gate_xavier_(w, generator=torch.Generator().manual_seed(1))
        self._std_close(w.numpy(), np.asarray(ref))
        # per gate: fan_out is the gate's 64 channels, not 256
        expect = math.sqrt(2.0 / (32 * 9 + 64 * 9))
        assert abs(float(w.std()) - expect) <= 0.04 * expect

    def test_lstm_cell_defaults(self):
        import flax.linen as nn
        key = jax.random.key(2)
        ref_in = nn.initializers.lecun_normal()(key, (256, 128))
        ref_rec = nn.initializers.orthogonal()(key, (128, 128))
        gen = torch.Generator().manual_seed(2)
        w_in = port_init.lecun_normal_(torch.empty(128, 256), gen)
        w_rec = port_init.orthogonal_(torch.empty(128, 128), gen)
        self._std_close(w_in.numpy(), np.asarray(ref_in))
        assert float(w_in.abs().max()) <= 2 * math.sqrt(1 / 256) / 0.8796 + 1e-6
        np.testing.assert_allclose((w_rec @ w_rec.T).numpy(), np.eye(128), atol=1e-5)
        self._std_close(w_rec.numpy(), np.asarray(ref_rec))

    def test_init_from_seed_reproducible(self):
        from txt2vid_tpu_torch.models.layers import UpBlock
        a = port_init.init_from_seed(UpBlock(8, 4), 5).state_dict()
        b = port_init.init_from_seed(UpBlock(8, 4), 5).state_dict()
        c = port_init.init_from_seed(UpBlock(8, 4), 6).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["conv1.weight"], c["conv1.weight"])


# (B, N, M, d, dv): both kernel instantiations, and N, M that no power-of-two
# tile divides (the JAX kernel's _pick_block falls back to odd divisors there)
ATTENTION_SHAPES = [(2, 64, 16, 4, 16), (2, 90, 22, 4, 16),
                    (1, 48, 12, 16, 64), (2, 45, 15, 16, 64)]


class TestAttention:
    @pytest.mark.parametrize("shape", ATTENTION_SHAPES)
    def test_plain_matches_jax_core(self, shape):
        theta, phi, g = _attention_inputs(10, *shape)
        ref = jax_attention.attention_core(jnp.asarray(theta), jnp.asarray(phi),
                                           jnp.asarray(g))
        got = port_attention.attention_core(torch.from_numpy(theta),
                                            torch.from_numpy(phi), torch.from_numpy(g))
        assert_close(ref, got, 2e-5, "attention_core")

    @pytest.mark.parametrize("shape", ATTENTION_SHAPES)
    def test_reference_matches_pallas_interpret(self, shape):
        # logits scaled up so the online softmax's running max really moves
        theta, phi, g = _attention_inputs(11, *shape, logit_scale=2.0)
        o_ref, lse_ref = jax_fused_attention(
            jnp.asarray(theta), jnp.asarray(phi), jnp.asarray(g),
            block_n=16, block_m=8, interpret=True, return_lse=True)
        o, lse = fused_attention_reference(torch.from_numpy(theta),
                                           torch.from_numpy(phi),
                                           torch.from_numpy(g), return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == shape[:2]
        assert_close(o_ref, o, 2e-5, "o")
        assert_close(lse_ref, lse, 2e-5, "lse")

    def test_bf16_reference_returns_g_dtype(self):
        theta, phi, g = (torch.from_numpy(a).bfloat16()
                         for a in _attention_inputs(12, 1, 32, 8, 4, 16))
        o, lse = fused_attention_reference(theta, phi, g, return_lse=True)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        o32 = fused_attention_reference(theta.float(), phi.float(), g.float())
        assert_close(o32, o.float(), 1e-2, "bf16 o")


class TestDispatch:
    def test_cpu_tensor_takes_plain_version(self):
        theta, phi, g = (torch.from_numpy(a) for a in _attention_inputs(13, 2, 64, 16, 4, 16))
        before = fused_attention.launches
        o, lse = fused_attention(theta, phi, g, return_lse=True)
        auto = port_attention.attention_core_auto(theta, phi, g)
        assert fused_attention.launches == before
        ref_o, ref_lse = fused_attention_reference(theta, phi, g, return_lse=True)
        assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
        assert_close(port_attention.attention_core(theta, phi, g), auto, 1e-6, "auto")

    def test_no_kernel_and_use_kernel_take_plain_core(self, monkeypatch):
        calls = []
        monkeypatch.setattr(port_attention, "fused_attention",
                            lambda *a, **k: calls.append(1))
        theta, phi, g = (torch.from_numpy(a) for a in _attention_inputs(14, 1, 16, 4, 4, 16))
        with port_attention.no_kernel():
            port_attention.attention_core_auto(theta, phi, g)
        port_attention.attention_core_auto(theta, phi, g, use_kernel=False)
        assert calls == []
        port_attention.attention_core_auto(theta, phi, g)
        assert calls == [1]

    @pytest.mark.parametrize("bad", ["dv", "dtype", "batch", "contiguous", "device"])
    def test_wrapper_rejects_what_the_kernel_does_not_take(self, bad):
        theta, phi, g = (torch.from_numpy(a) for a in _attention_inputs(15, 2, 16, 4, 4, 16))
        if bad == "dv":
            # CPU tensors take the plain version at any width; the kernels'
            # own check refuses a (d, dv) they are not built for
            assert fused_attention(theta, phi, torch.zeros(2, 4, 8)).shape == (2, 16, 8)
            with pytest.raises(ValueError, match="no kernel"):
                _check_kernel(2, 16, 4, 4, 8)
            return
        if bad == "dtype":
            theta, phi, g = theta.double(), phi.double(), g.double()
        elif bad == "batch":
            phi = phi[:1]
        elif bad == "contiguous":
            theta = theta.transpose(1, 2).contiguous().transpose(1, 2)
        elif bad == "device":
            theta, phi, g = theta.to("meta"), phi.to("meta"), g.to("meta")
        with pytest.raises((ValueError, TypeError)):
            fused_attention(theta, phi, g)

    def test_supported_pairs_are_the_models(self):
        # Attention(32) in the 64-px generator's up1, Attention(64) in the
        # cond-128 generator's up0 and Attention3d(128) in the discriminator:
        # d = ch/8, dv = ch/2
        assert SUPPORTED_DV == {32 // 8: 32 // 2, 64 // 8: 64 // 2, 128 // 8: 128 // 2}


class TestEntryPointsNeedCuda:
    def test_service_without_device_raises_without_cuda(self, monkeypatch):
        from txt2vid_tpu_torch.gan.cond_gan import CondGan
        from txt2vid_tpu_torch.serve import GeneratorService
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeneratorService(CondGan(torch.nn.Identity()))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GeneratorService.from_seed(None)
