"""txt2vid_tpu_torch.models against txt2vid_tpu.models on the CPU.

Each JAX module gets a variable tree of random numpy values in which nothing
keeps its init value (every attention gamma nonzero, every bias and BatchNorm
affine parameter random, BN running statistics random: at their init values
eval-mode BN and a zero gamma hide layout bugs). The tree is carried into the
port with txt2vid_tpu_torch.convert, and both run in eval mode on the same
numpy inputs. The JAX attention runs the
Pallas kernel in interpret mode (use_pallas=True with INTERPRET set).
Tolerances: a block through attention 2e-5 * scale, the whole generator 1e-4.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txt2vid_tpu.models import conv_lstm as jax_conv_lstm
from txt2vid_tpu.models import layers as jax_layers
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models import txt as jax_txt
from txt2vid_tpu.ops import attention as jax_attention
from txt2vid_tpu_torch.convert import jax_to_torch_encoder, jax_to_torch_generator
from txt2vid_tpu_torch.models import conv_lstm, layers, tganv2, txt


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


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas attention in interpret mode on the CPU."""
    prev = jax_attention.INTERPRET
    jax_attention.INTERPRET = True
    try:
        yield
    finally:
        jax_attention.INTERPRET = prev


def random_variables(shapes, rng):
    """Random values for a flax variable tree of shapes: kernels normal with
    variance 1/fan_in, and every leaf that a module initialises to a constant
    (biases, BN scale, gamma, running mean and variance) random too."""
    out = {}
    for k, v in shapes.items():
        if hasattr(v, "items"):
            out[k] = random_variables(v, rng)
            continue
        if k == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(v.shape[:-1])), v.shape)
        elif k == "embedding":
            a = rng.normal(0.0, 1.0, v.shape)
        elif k in ("bias", "wx0_bias", "mean"):
            a = rng.normal(0.0, 0.2, v.shape)
        elif k == "scale":
            a = 1.0 + rng.normal(0.0, 0.2, v.shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, v.shape)
        elif k == "gamma":
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            raise KeyError(f"no rule for variable {k}")
        out[k] = np.asarray(a, np.float32)
    return out


def jax_variables(module, seed, *args, **kwargs):
    """The module's variable tree (shapes from tracing its init, which is
    cheaper on the CPU than running it), filled by `random_variables`."""
    with pallas_interpret():
        shapes = jax.eval_shape(lambda: module.init(
            {"params": jax.random.key(0), "sample": jax.random.key(1)}, *args, **kwargs))
    return random_variables(shapes, np.random.default_rng(seed))


def jax_apply(module, variables, *args, **kwargs):
    """module.apply compiled once (faster on the CPU than op by op), with the
    Pallas attention in interpret mode."""
    with pallas_interpret():
        return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def port_submodule_state(prefix, variables):
    """Convert a lone block's tree by nesting it where the generator keeps such a
    block (`up0`, `render0`, `clstm`) and stripping that prefix again."""
    sd = jax_to_torch_generator({prefix: variables["params"]},
                                {prefix: variables["batch_stats"]}
                                if "batch_stats" in variables else None)
    return {k[len(prefix) + 1:]: v for k, v in sd.items()}


def nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


class TestBlocks:
    def test_upblock_with_non_local(self):
        # ch 32 after the block: d = 4, dv = 16, N = 16*16, M = 8*8
        x = np.random.default_rng(0).standard_normal((2, 8, 8, 64)).astype(np.float32)
        block = jax_layers.UpBlock(64, 32, with_non_local=True, use_pallas=True)
        variables = jax_variables(block, 1, jnp.asarray(x), train=True)
        assert float(variables["params"]["attn"]["gamma"]) != 0.0
        ref = jax_apply(block, variables, jnp.asarray(x), train=False)
        port = layers.UpBlock(64, 32, with_non_local=True).eval()
        port.load_state_dict(port_submodule_state("up0", variables))
        with torch.no_grad():
            got = port(nhwc_to_nchw(x)).permute(0, 2, 3, 1)
        assert_close(ref, got, 2e-5, "UpBlock")

    def test_attention_reaches_video(self):
        """The attention branch matters to the output once gamma != 0: zeroing
        gamma in the port changes it by far more than the tolerance."""
        x = np.random.default_rng(2).standard_normal((1, 8, 8, 64)).astype(np.float32)
        block = jax_layers.UpBlock(64, 32, with_non_local=True, use_pallas=False)
        variables = jax_variables(block, 3, jnp.asarray(x), train=True)
        port = layers.UpBlock(64, 32, with_non_local=True).eval()
        port.load_state_dict(port_submodule_state("up0", variables))
        with torch.no_grad():
            a = port(nhwc_to_nchw(x))
            port.attn.gamma.zero_()
            b = port(nhwc_to_nchw(x))
        assert float((a - b).abs().max()) > 1e-2

    def test_render_block(self):
        x = np.random.default_rng(4).standard_normal((3, 8, 8, 16)).astype(np.float32)
        block = jax_layers.RenderBlock(16, 3)
        variables = jax_variables(block, 5, jnp.asarray(x), train=True)
        ref = jax_apply(block, variables, jnp.asarray(x), train=False)
        port = layers.RenderBlock(16, 3).eval()
        port.load_state_dict(port_submodule_state("render0", variables))
        with torch.no_grad():
            got = port(nhwc_to_nchw(x)).permute(0, 2, 3, 1)
        assert_close(ref, got, 1e-5, "RenderBlock")


class TestConvLSTM:
    @pytest.mark.parametrize("plane,hidden", [(1, (16,)), (2, (16,)), (2, (8, 12))])
    def test_matches_jax(self, plane, hidden):
        x = np.random.default_rng(6).standard_normal((2, plane, plane, 10)).astype(np.float32)
        module = jax_conv_lstm.ConvLSTM(hidden_channels=hidden, step=5)
        variables = jax_variables(module, 7, jnp.asarray(x))
        ref = jax_apply(module, variables, jnp.asarray(x))            # (B, T, h, w, C)
        port = conv_lstm.ConvLSTM(10, hidden, step=5)
        port.load_state_dict(port_submodule_state("clstm", variables))
        with torch.no_grad():
            got = port(nhwc_to_nchw(x)).permute(0, 1, 3, 4, 2)
        assert_close(ref, got, 1e-5, "ConvLSTM")


# the small conditional generator: up0 carries Attention(32), so d = 4, dv = 16,
# N = 16*16 and M = 8*8 at width 32
SMALL_GEN = dict(latent_size=16, width=32, height=32, num_channels=3,
                 fm_channels=32, additional_blocks=(32, 16), num_frames=4, cond_dim=16)


def small_generator(seed, **overrides):
    """(JAX generator, its variables, the port generator loaded with them). The
    tree is traced in train mode so that every scale's render exists."""
    cfg = {**SMALL_GEN, **overrides}
    gen = jax_tganv2_cond.MultiScaleGen(**cfg, use_pallas=True)
    variables = jax_variables(gen, seed, jnp.zeros((4, cfg["latent_size"])),
                              jnp.zeros((4, cfg["cond_dim"])), train=True)
    port = tganv2.MultiScaleGen(**cfg, with_non_local=True).eval()
    port.load_state_dict(jax_to_torch_generator(variables["params"],
                                                variables["batch_stats"]))
    return gen, variables, port


class TestMultiScaleGen:
    @pytest.mark.parametrize("overrides", [{}, {"width": 64, "height": 64, "fm_stride": 32}],
                             ids=["plane1x1", "plane2x2"])
    def test_eval_matches_jax(self, overrides):
        gen, variables, port = small_generator(8, **overrides)
        rng = np.random.default_rng(9)
        z = rng.standard_normal((2, 16)).astype(np.float32)
        cond = rng.standard_normal((2, 16)).astype(np.float32)
        ref = jax_apply(gen, variables, jnp.asarray(z), jnp.asarray(cond), train=False,
                        output_blocks=(0,))
        with torch.no_grad():
            got = port(torch.from_numpy(z), torch.from_numpy(cond), output_blocks=(0,))
        assert len(ref) == len(got) == 2
        for r, o in zip(ref, got):
            assert_close(r, o, 1e-4, "MultiScaleGen")
        size = overrides.get("width", 32)
        assert got[-1].shape == (2, 4, size, size, 3)

    def test_train_mode_waits_for_training_slice(self):
        """The training slice has landed: train=True renders every scale, the
        batch and frames halving before each block after the base, with the
        subsample phases drawn from the given generator (see
        test_torch_train_models for the parity with JAX)."""
        port = tganv2.MultiScaleGen(**SMALL_GEN).train()
        z, cond = torch.randn(4, 16), torch.randn(4, 16)
        with torch.no_grad():
            a = port(z, cond, train=True, generator=torch.Generator().manual_seed(3))
            b = port(z, cond, train=True, generator=torch.Generator().manual_seed(3))
        assert [tuple(v.shape) for v in a] == [(4, 4, 8, 8, 3), (2, 2, 16, 16, 3),
                                               (1, 1, 32, 32, 3)]
        assert all(torch.allclose(x, y, atol=1e-6) for x, y in zip(a, b))

    def test_flagship_partial(self):
        from txt2vid_tpu_torch.models import tganv2_cond
        port = tganv2_cond.MultiScaleGen(latent_size=8, fm_channels=16,
                                         additional_blocks=(16, 32, 8))
        assert (port.fm_h, port.fm_w) == (1, 1) and port.fc.in_features == 8 + 256
        assert port.up1.attn is not None and port.up0.attn is None
        assert port.up2.attn is None


class TestConvert:
    def test_unmapped_generator_key_raises(self):
        _, variables, _ = small_generator(10)
        params = dict(variables["params"])
        params["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(KeyError, match="mystery"):
            jax_to_torch_generator(params, variables["batch_stats"])

    def test_unmapped_encoder_key_raises(self):
        with pytest.raises(KeyError, match="decoder"):
            jax_to_torch_encoder({"encoder": {"decoder": {"kernel": np.zeros(2)}}})


def _captions(seed, b, length, vocab, lengths):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, length)).astype(np.int32)
    for i, n in enumerate(lengths):
        toks[i, n:] = 0
    return toks, np.asarray(lengths, np.int32)


class TestSeq2Seq:
    @pytest.mark.parametrize("num_layers", [1, 2])
    def test_encode_matches_jax(self, num_layers):
        vocab, length = 20, 8
        toks, lens = _captions(11, 4, length, vocab, [8, 3, 5, 1])
        enc = jax_txt.Seq2Seq(vocab_size=vocab, embed_size=8, hidden_size=16,
                              num_layers=num_layers)
        variables = jax_variables(enc, 12, jnp.asarray(toks), jnp.asarray(lens))
        out_ref, _, hn_ref = jax_apply(enc, variables, jnp.asarray(toks),
                                       jnp.asarray(lens), method=enc.encode)
        port = txt.Seq2Seq(vocab_size=vocab, embed_size=8, hidden_size=16,
                           num_layers=num_layers)
        port.load_state_dict(jax_to_torch_encoder(variables["params"]))
        with torch.no_grad():
            out, _, hn = port.encode(torch.from_numpy(toks).long(), torch.from_numpy(lens))
        assert_close(hn_ref, hn, 1e-5, "hn")
        # outputs are compared where the caption is; past its end the port's
        # packed sequence gives zeros and flax leaves what the cell computed
        valid = np.arange(length)[None, :] < lens[:, None]
        assert_close(np.asarray(out_ref)[valid], out.numpy()[valid], 1e-5, "out")
        assert float(out.numpy()[~valid].__abs__().max()) == 0.0
