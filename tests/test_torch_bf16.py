"""bfloat16 compute in txt2vid_tpu_torch against txt2vid_tpu on the CPU.

The JAX side runs with dtype=jnp.bfloat16 and its plain attention
(use_pallas=False), each function jitted once; inputs and variables come from
numpy seeds (test_torch_models' `random_variables`: nothing at its init value).

- Each bf16 module against its flax counterpart, forward in train mode where
  BatchNorm has one: UpBlock with Attention, DownBlock, RenderBlock, ConvLSTM,
  Resnet3D with Attention3d, MultiScaleGen and MultiScaleDiscrim, and the
  output dtypes (bf16 where flax gives bf16, float32 features and logits).
  Tolerance 2e-2 * max(1, max|ref|) for a block (bf16's epsilon is 7.8e-3; the
  two sides round convolutions and fused elementwise chains differently),
  4e-2 for the whole generator and the ConvLSTM's unrolled steps.
- Two pins: the bf16 average pool sums its window in bf16 in JAX's order (bit
  for bit), and BatchNorm takes float32 statistics of a bf16 input and
  updates its float32 running statistics as flax does (1e-6), its bf16 output
  within one bf16 ulp (2^-8 relative).
- ops.optim.AdamStorage against optax.adam(mu_dtype=bf16) and
  txt2vid_tpu.ops.optim.adam_storage over 20 steps: stored moments within one
  bf16 ulp, parameters within 1e-6 relative.
- One train step at --bf16, --bf16 --bf16_nu --bf16_params and --bf16_params
  alone, from one state, batch and set of draws, against the jitted JAX step.
  Raw bf16 differences compound, so each side is held to the port's float32
  step of the same state: the port's Adam first moments no further from it
  than 2x JAX's (the largest distance over leaves, each over its leaf scale),
  and the losses within 2e-2 relative of JAX's (the JAX package's own rule in
  test_compute_dtype_copy_matches_per_use_casts). Stored parameters stay
  float32 and the caption encoder computes in float32. With -s the test
  prints both distances (port 0.889 / 0.714 / 0.328 against JAX's 2.916 /
  2.711 / 0.328 at the three flag sets).
- chip_smoke's in-step rule for the bf16 kernels (leaf by leaf, 2x the plain
  step's distance floored at two bf16 ulps) through the kernels' plain
  versions: it passes them and fails a backward with dtheta zeroed or dg 10%
  off; the leaves it does not hold are the D heads' biases under RSGAN,
  which get no gradient, and a bf16 copy's gradient summed over several uses
  depends on the order, in the port and in JAX alike.
- The checkpoint of a bf16-moment state is byte for byte what flax's
  serializer writes, and restores under a float32 config and back.
- `serve --bf16` against txt2vid_tpu.serve with bf16=True from one
  checkpoint at the JAX service's z: uint8 within 3 levels (measured: 3; a
  bf16 rounding of the video alone moves a pixel by up to one level, and the
  two sides round every layer before it differently).
"""

import json

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from test_torch_models import jax_variables, nhwc_to_nchw, port_submodule_state, random_variables
from test_torch_serve import SENTENCES, SPEC_D, SPEC_G, SPEC_S, WORDS
from test_torch_train_models import port_disc_state, to_ncdhw
from test_torch_train_step import scaled_kernels
from txt2vid_tpu.data import Vocab as JaxVocab
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
from txt2vid_tpu.gan.train_step import init_state_abstract
from txt2vid_tpu.models import conv_lstm as jax_conv_lstm
from txt2vid_tpu.models import layers as jax_layers
from txt2vid_tpu.models import resnet3d as jax_resnet3d
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.ops import optim as jax_optim
from txt2vid_tpu.ops import pooling as jax_pooling
from txt2vid_tpu.ops import subsample as jax_subsample
from txt2vid_tpu.serve import GeneratorService as JaxService
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu.utils import misc as jax_misc
from txt2vid_tpu_torch.convert import (jax_state_to_torch, jax_to_torch_discriminator,
                                       jax_to_torch_generator, torch_state_to_jax)
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import Draws, TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import conv_lstm, layers, resnet3d, tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops import attention as attention_mod
from txt2vid_tpu_torch.ops.optim import AdamStorage
from txt2vid_tpu_torch.ops.pooling import avg_pool_3d_shape_aware
from txt2vid_tpu_torch.serve import GeneratorService
from txt2vid_tpu_torch.utils import checkpoint, msgpack

BF = jnp.bfloat16
TOL, TOL_DEEP = 2e-2, 4e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(ref, got, tol, what):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    got = got.detach().float().numpy().astype(np.float64)
    assert ref.shape == got.shape, f"{what}: {ref.shape} vs {got.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol * scale, f"{what}: max|diff| {err} > {tol} * {scale}"


def bf16_numpy(shape, seed, low=None):
    """Normal (or uniform(low, 1)) float32 values rounded to bf16, as float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(low, 1, shape) if low is not None else rng.standard_normal(shape)
    return np.asarray(jnp.asarray(a, jnp.float32).astype(BF).astype(jnp.float32))


def to_port(a, layout=None):
    t = torch.from_numpy(np.array(a))
    if layout == "nchw":
        t = nhwc_to_nchw(a)
    elif layout == "ncdhw":
        t = to_ncdhw(a)
    return t.to(torch.bfloat16)


def apply_train(module, variables, *args, **kwargs):
    """module.apply in train mode, jitted: (output, new batch_stats)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, train=True, mutable=["batch_stats"],
                                              **kwargs))(variables, *args)


def assert_stats_close(port, updates, prefix):
    ref = {k: v for k, v in port_submodule_state(prefix, {"params": {}, **updates}).items()
           if "running" in k}
    got = port.state_dict()
    assert ref
    for k, r in ref.items():
        assert got[k].dtype == torch.float32, k
        close(r.numpy(), got[k], 1e-3, k)


# ------------------------------------------------------------------ the modules

class TestModules:
    def test_upblock_with_attention(self):
        x = bf16_numpy((2, 8, 8, 64), 0)
        block = jax_layers.UpBlock(64, 32, with_non_local=True, use_pallas=False, dtype=BF)
        variables = jax_variables(block, 1, jnp.asarray(x), train=True)
        ref, updates = apply_train(block, variables, jnp.asarray(x, BF))
        port = layers.UpBlock(64, 32, with_non_local=True, dtype=torch.bfloat16).train()
        port.load_state_dict(port_submodule_state("up0", variables))
        with torch.no_grad():
            got = port(to_port(x, "nchw")).permute(0, 2, 3, 1)
        assert ref.dtype == BF and got.dtype == torch.bfloat16
        close(ref, got, TOL, "UpBlock")
        assert_stats_close(port, updates, "up0")

    def test_down_block(self):
        x = bf16_numpy((2, 4, 6, 5, 16), 2)     # odd W: the pool pads
        block = jax_layers.DownBlock(16, 32, dtype=BF)
        variables = jax_variables(block, 3, jnp.asarray(x))
        ref = jax.jit(block.apply)(variables, jnp.asarray(x, BF))
        port = layers.DownBlock(16, 32, dtype=torch.bfloat16)
        port.load_state_dict(port_disc_state("down0", variables["params"]))
        with torch.no_grad():
            got = port(to_port(x, "ncdhw")).permute(0, 2, 3, 4, 1)
        assert ref.dtype == BF and got.dtype == torch.bfloat16
        close(ref, got, TOL, "DownBlock")

    def test_render_block(self):
        x = bf16_numpy((3, 8, 8, 16), 4)
        block = jax_layers.RenderBlock(16, 3, dtype=BF)
        variables = jax_variables(block, 5, jnp.asarray(x), train=True)
        ref, updates = apply_train(block, variables, jnp.asarray(x, BF))
        port = layers.RenderBlock(16, 3, dtype=torch.bfloat16).train()
        port.load_state_dict(port_submodule_state("render0", variables))
        with torch.no_grad():
            got = port(to_port(x, "nchw")).permute(0, 2, 3, 1)
        assert ref.dtype == BF and got.dtype == torch.bfloat16
        close(ref, got, TOL, "RenderBlock")
        assert_stats_close(port, updates, "render0")

    @pytest.mark.parametrize("plane", [1, 2])
    def test_conv_lstm(self, plane):
        x = bf16_numpy((2, plane, plane, 10), 6)
        module = jax_conv_lstm.ConvLSTM(hidden_channels=(16,), step=5, dtype=BF)
        variables = jax_variables(module, 7, jnp.asarray(x))
        ref = jax.jit(module.apply)(variables, jnp.asarray(x, BF))
        port = conv_lstm.ConvLSTM(10, (16,), step=5, dtype=torch.bfloat16)
        port.load_state_dict(port_submodule_state("clstm", variables))
        with torch.no_grad():
            got = port(to_port(x, "nchw")).permute(0, 1, 3, 4, 2)
        assert ref.dtype == BF and got.dtype == torch.bfloat16
        close(ref, got, TOL_DEEP, "ConvLSTM")

    def test_resnet3d_with_attention3d(self):
        # down0's output is 2 x 4 x 4 at 128 channels: Attention3d at d = 16,
        # dv = 64, N = 32, M = 8
        x = bf16_numpy((3, 4, 16, 16, 3), 8, low=-1)
        cond = np.random.default_rng(9).standard_normal((3, 8)).astype(np.float32)
        kw = dict(num_channels=3, cond_dim=8, num_down_blocks=2, cond_head="proj")
        net = jax_resnet3d.Resnet3D(**kw, use_pallas=False, dtype=BF)
        variables = jax_variables(net, 10, jnp.asarray(x), jnp.asarray(cond))
        ref = jax.jit(net.apply)(variables, jnp.asarray(x, BF), jnp.asarray(cond))
        port = resnet3d.Resnet3D(**kw, dtype=torch.bfloat16)
        port.load_state_dict(port_disc_state("", variables["params"]))
        with torch.no_grad():
            got = port(to_port(x), torch.from_numpy(cond))
        for r, g, what in zip(ref, got, ("uncond", "cond", "features")):
            assert r.dtype == jnp.float32 and g.dtype == torch.float32, what
            close(r, g, TOL, what)

    def test_multiscale_gen(self):
        cfg = dict(latent_size=16, width=32, height=32, num_channels=3, fm_channels=32,
                   additional_blocks=(32, 16), num_frames=4, cond_dim=16)
        gen = jax_tganv2_cond.MultiScaleGen(**cfg, use_pallas=False, dtype=BF)
        variables = jax_variables(gen, 11, jnp.zeros((4, 16)), jnp.zeros((4, 16)),
                                  train=True)
        rng = np.random.default_rng(12)
        z, cond = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))
        ref = jax.jit(lambda v, z, c: gen.apply(v, z, c, train=False, output_blocks=(0,)))(
            variables, jnp.asarray(z), jnp.asarray(cond))
        port = tganv2.MultiScaleGen(**cfg, with_non_local=True, dtype=torch.bfloat16).eval()
        port.load_state_dict(jax_to_torch_generator(variables["params"],
                                                    variables["batch_stats"]))
        with torch.no_grad():
            got = port(torch.from_numpy(z), torch.from_numpy(cond), output_blocks=(0,))
        assert len(ref) == len(got) == 2
        for r, g in zip(ref, got):
            assert r.dtype == BF and g.dtype == torch.bfloat16
            close(r, g, TOL_DEEP, "MultiScaleGen")

    def test_multiscale_discrim(self):
        scales = [bf16_numpy((2, 4, 16, 16, 3), 13, low=-1),
                  bf16_numpy((1, 2, 32, 32, 3), 14, low=-1)]
        conds = [np.random.default_rng(15).standard_normal((b, 8)).astype(np.float32)
                 for b in (2, 1)]
        disc = jax_tganv2_cond.MultiScaleDiscrim(discrim_down_blocks=(1, 1), num_channels=3,
                                                 cond_dim=8, use_pallas=False, dtype=BF)
        variables = jax_variables(disc, 16, [jnp.asarray(s) for s in scales],
                                  cond=[jnp.asarray(c) for c in conds])
        ref = jax.jit(lambda v, x, c: disc.apply(v, x, cond=c))(
            variables, [jnp.asarray(s) for s in scales], [jnp.asarray(c) for c in conds])
        port = tganv2.MultiScaleDiscrim(discrim_down_blocks=(1, 1), num_channels=3,
                                        cond_dim=8, dtype=torch.bfloat16)
        port.load_state_dict(jax_to_torch_discriminator(variables["params"]))
        with torch.no_grad():
            got = port([torch.from_numpy(s) for s in scales],
                       cond=[torch.from_numpy(c) for c in conds])
        for r_scale, g_scale in zip(ref, got):
            for r, g in zip(r_scale, g_scale):
                assert r.dtype == jnp.float32 and g.dtype == torch.float32
                close(r, g, TOL, "MultiScaleDiscrim")


# ------------------------------------------------------------------------ pins

def test_avg_pool_sums_in_bf16_in_jax_order():
    """JAX's reduce_window adds the window in bf16, (t, h, w) in order; torch
    would accumulate in float32 and round once, a one-ulp difference."""
    x = bf16_numpy((2, 5, 6, 7, 8), 20) * 3
    pool = jax.jit(jax_pooling.avg_pool_3d_shape_aware)
    ref = np.asarray(pool(jnp.asarray(x, BF)).astype(jnp.float32))
    xt = to_port(x, "ncdhw").requires_grad_()
    got = avg_pool_3d_shape_aware(xt).permute(0, 2, 3, 4, 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().detach().numpy(), ref)
    # the gradient is the average pool's, as JAX's (exact in bf16)
    w = bf16_numpy(ref.shape, 23)
    (got * to_port(w)).sum().backward()
    ref_grad = jax.jit(jax.grad(lambda v: jnp.sum(pool(v).astype(jnp.float32) * w)))(
        jnp.asarray(x, BF))
    np.testing.assert_array_equal(xt.grad.float().permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(ref_grad.astype(jnp.float32)))
    once = torch.nn.functional.avg_pool3d(to_port(x, "ncdhw").float(), 2, 2, padding=(1, 0, 1),
                                          count_include_pad=True)
    assert not torch.equal(once.to(torch.bfloat16).float().permute(0, 2, 3, 4, 1),
                           got.detach().float()), "the pin sees no difference at these inputs"
    ref_stem = np.asarray(jax.jit(jax_resnet3d._avg_pool_122_s2)(
        jnp.asarray(x[:, :4, :6, :6], BF)).astype(jnp.float32))
    got_stem = resnet3d.avg_pool_122_s2(to_port(x[:, :4, :6, :6], "ncdhw"))
    np.testing.assert_array_equal(got_stem.float().permute(0, 2, 3, 4, 1).numpy(), ref_stem)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_in_bf16(train):
    """flax BatchNorm(dtype=bf16): float32 statistics of the bf16 input,
    normalisation in float32, a bf16 result; the running statistics float32."""
    x = bf16_numpy((4, 6, 6, 16), 21) * 2 + 0.5
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=BF)
    variables = random_variables(jax.eval_shape(
        lambda: bn.init(jax.random.key(0), jnp.zeros(x.shape))), np.random.default_rng(22))
    ref, updates = jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(x, BF))
    port = layers.BatchNorm2d(16, eps=1e-5, compute_dtype=torch.bfloat16).train(train)
    sd = {"weight": variables["params"]["scale"], "bias": variables["params"]["bias"],
          "running_mean": variables["batch_stats"]["mean"],
          "running_var": variables["batch_stats"]["var"]}
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                         strict=False)
    with torch.no_grad():
        got = port(to_port(x, "nchw")).permute(0, 2, 3, 1)
    assert ref.dtype == BF and got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(got.float().numpy() - ref32) <= 2.0 ** -8 * np.abs(ref32) + 1e-6)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        r = np.asarray(updates["batch_stats"][key])
        t = getattr(port, name)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- optimizer

def _bf16_ulp(ref):
    """One bf16 ulp at each of ref's values (a floor for zeros)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("mu,nu", [("bfloat16", None), ("bfloat16", "bfloat16"),
                                   (None, "bfloat16")], ids=["bf16", "bf16_nu", "nu_only"])
def test_adam_storage_matches_optax(mu, nu):
    """--bf16 is optax.adam(mu_dtype=bf16); --bf16_nu adam_storage. 20 steps of
    random gradients at b1 0.9 (0.5, the CLI's, scales mu exactly)."""
    rng = np.random.default_rng(30)
    shapes = {"a": (8, 5), "b": (7,), "c": (3, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(b1=0.9, b2=0.999, eps=1e-8)
    if nu is None:
        opt = optax.adam(1e-2, mu_dtype=BF, **kw)
    else:
        opt = jax_optim.adam_storage(1e-2, mu_dtype=BF if mu else None, nu_dtype=BF, **kw)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, opt.init(params)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    port = AdamStorage(list(tp.values()), lr=1e-2, mu_dtype=mu and torch.bfloat16,
                       nu_dtype=nu and torch.bfloat16, **kw)
    for _ in range(20):
        grads = {k: (rng.standard_normal(s) * rng.uniform(0.1, 3)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, state = update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        port.step()
    for k, p in tp.items():
        ref = np.asarray(jp[k])
        assert float(np.abs(p.detach().numpy() - ref).max()) <= 1e-6 * float(np.abs(ref).max())
        st = port.state[p]
        assert int(st["step"]) == 20 == int(state[0].count)
        for key, tree, dtype in (("exp_avg", state[0].mu, mu), ("exp_avg_sq", state[0].nu, nu)):
            assert st[key].dtype == (torch.bfloat16 if dtype else torch.float32)
            assert tree[k].dtype == (BF if dtype else jnp.float32)
            ref_m = np.asarray(tree[k].astype(jnp.float32))
            assert np.all(np.abs(st[key].float().numpy() - ref_m) <= _bf16_ulp(ref_m)), key


# ---------------------------------------------------------------- train steps

# tests/test_train_step.py's tiny bf16 specs (16 px, 4 frames, fm_channels 16)
# with the caption encoder; the attention is D's (G's needs a third scale,
# TestModules holds it)
GEN = dict(latent_size=16, width=16, height=16, num_channels=3, fm_channels=16,
           additional_blocks=(8,), num_frames=4, cond_dim=16)
DISC = dict(discrim_down_blocks=(1, 1), num_channels=3, cond_dim=16)
ENC = dict(vocab_size=20, embed_size=16, hidden_size=16, num_layers=1)
FRAME_SIZES, B, LR = (8, 16), 4, 2e-4
# (--bf16, --bf16_nu, --bf16_params)
FLAGS = {"bf16": (True, False, False), "bf16_nu_params": (True, True, True),
         "params_alone": (False, False, True)}


def _batch():
    rng = np.random.default_rng(40)
    caps = rng.integers(1, ENC["vocab_size"], (B, 6)).astype(np.int32)
    lens = np.array([6, 3, 5, 2], np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    return rng.uniform(-1, 1, (B, 4, 16, 16, 3)).astype(np.float32), caps, lens


def _jax_opt(bf16, nu):
    if nu:
        return jax_optim.adam_storage(LR, b1=0.5, b2=0.999, mu_dtype=BF if bf16 else None,
                                      nu_dtype=BF)
    return optax.adam(LR, b1=0.5, b2=0.999, mu_dtype=BF if bf16 else None)


def _jax_gan(bf16):
    dtype = BF if bf16 else None
    return JaxCondGan(gen=jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=False, dtype=dtype),
                      discrims=[jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False,
                                                                  dtype=dtype)],
                      cond_encoder=JaxSeq2Seq(**ENC))


def _jax_config(params):
    return JaxTrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                          latent_size=GEN["latent_size"], shared_gen_fwd=True,
                          compute_dtype=BF if params else None)


def _jax_state(flags):
    """A random state (variables as test_torch_train_step's, kernels at half
    scale) with the flags' optimizer states."""
    bf16, nu, params = flags
    video, caps, lens = _batch()
    opt = _jax_opt(bf16, nu)
    shapes = init_state_abstract(_jax_gan(bf16), jax.random.key(0),
                                 {"video": video, "captions": caps, "lengths": lens},
                                 opt, opt, _jax_config(params))
    rng = np.random.default_rng(41)
    g_vars = scaled_kernels(random_variables(shapes.g_vars, rng))
    d_vars = (scaled_kernels(random_variables(shapes.d_vars[0], rng)),)
    t_vars = random_variables(shapes.txt_vars, rng)
    return shapes.replace(g_vars=g_vars, d_vars=d_vars, txt_vars=t_vars,
                          opt_g_state=opt.init({"g": g_vars["params"]}),
                          opt_d_state=opt.init({"d": (d_vars[0]["params"],)}))


def _run_jax(flags):
    """The jitted JAX step at `flags` from _jax_state: (state before, state
    after, metrics, draws)."""
    mp = pytest.MonkeyPatch()
    rec = {"pyramid": [], "gen": [], "perm": []}

    def recording(name, fn, pick):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec[name].append(pick(out))
            return out
        return wrapped

    mp.setattr(jax_subsample, "subsample_video",
               recording("pyramid", jax_subsample.subsample_video, lambda o: o[1]))
    mp.setattr(jax_tganv2, "subsample_video",
               recording("gen", jax_tganv2.subsample_video, lambda o: o[1]))
    mp.setattr(jax_misc, "gen_perm_device",
               recording("perm", jax_misc.gen_perm_device, lambda o: o))
    bf16, nu, params = flags
    try:
        opt = _jax_opt(bf16, nu)
        step = jax_build_train_step(_jax_gan(bf16), jax_losses.RSGANLoss(), opt, opt,
                                    _jax_config(params))

        def run(state, batch, key):
            for v in rec.values():
                v.clear()
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        video, caps, lens = _batch()
        state = _jax_state(flags)
        new, metrics, draws = jax.jit(run)(
            state, {"video": jnp.asarray(video), "captions": jnp.asarray(caps),
                    "lengths": jnp.asarray(lens)}, jax.random.key(5))
    finally:
        mp.undo()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    k_z = jax.random.split(jax.random.fold_in(jax.random.key(5), 0), 5)[0]
    draws = dict(z=np.array(jax.random.normal(k_z, (B, GEN["latent_size"]))),
                 pyramid=[int(v) for v in draws["pyramid"]],
                 gen=[int(v) for v in draws["gen"]], perm=np.array(draws["perm"][0]))
    return host(state), host(new), {k: float(v) for k, v in metrics.items()}, draws


def _port_step(flags):
    """The port's TrainStep at `flags` (all False: float32) on fresh modules."""
    bf16, nu, params = flags
    dtype = torch.bfloat16 if bf16 else None
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True, dtype=dtype)
    disc = tganv2.MultiScaleDiscrim(**DISC, dtype=dtype)
    storage = dict(mu_dtype=dtype, nu_dtype=torch.bfloat16 if nu else None)
    cfg = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                      latent_size=GEN["latent_size"], shared_gen_fwd=True,
                      compute_dtype=torch.bfloat16 if params else None)
    return build_train_step(CondGan(gen, Seq2Seq(**ENC), discrims=[disc]),
                            port_losses.RSGANLoss(), adam(gen.parameters(), LR, **storage),
                            adam(disc.parameters(), LR, **storage), cfg)


def _run_port(flags, state, draws):
    step = _port_step(flags)
    jax_state_to_torch(serialization.to_state_dict(state), step)
    video, caps, lens = _batch()
    encoded, encode = [], step.gan.cond_encoder.encode

    def recording_encode(*a, **k):
        out = encode(*a, **k)
        encoded.append(out[2].dtype)
        return out

    step.gan.cond_encoder.encode = recording_encode
    weights = []
    conv = step.gan.gen.render_base.conv
    conv.register_forward_pre_hook(lambda m, i: weights.append(m.weight.dtype))
    metrics = step({"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
                    "lengths": torch.from_numpy(lens)},
                   Draws(torch.from_numpy(draws["z"]), draws["pyramid"], draws["gen"],
                         [torch.from_numpy(draws["perm"]).long()]))
    return step, {k: float(v) for k, v in metrics.items()}, encoded, weights


def _mu(step):
    """side -> name -> the Adam first moment as float32."""
    return {side: {n: step_opt.state[p]["exp_avg"].float() for n, p in m.named_parameters()}
            for side, m, step_opt in (("G", step.gan.gen, step.opt_g),
                                      ("D", step.gan.discrims[0], step.opt_d))}


def _jax_mu(new):
    return {"G": jax_to_torch_generator(new.opt_g_state[0].mu["g"]),
            "D": jax_to_torch_discriminator(new.opt_d_state[0].mu["d"][0])}


def _distance(mu, ref):
    """The largest max|mu - ref| over a leaf's scale, max|ref| floored at 1e-2
    of the side's largest (test_torch_train_step's leaf scale)."""
    worst = 0.0
    for side in ref:
        top = max(float(v.abs().max()) for v in ref[side].values())
        for n, r in ref[side].items():
            scale = max(float(r.abs().max()), 1e-2 * top)
            worst = max(worst, float((mu[side][n] - r).abs().max()) / scale)
    return worst


@pytest.fixture(scope="module")
def steps():
    """Per flag set: the JAX step, the port's, and the port's float32 step
    from the same state and draws."""
    out, ref = {}, None
    for name, flags in FLAGS.items():
        old, new, metrics, draws = _run_jax(flags)
        if ref is None:
            ref = _mu(_run_port((False, False, False), old, draws)[0])
        step, port_metrics, encoded, weights = _run_port(flags, old, draws)
        out[name] = dict(old=old, new=new, metrics=metrics, draws=draws, step=step,
                         port_metrics=port_metrics, encoded=encoded, weights=weights,
                         ref=ref)
    return out


@pytest.mark.parametrize("name", list(FLAGS))
def test_step_losses_agree_with_jax(steps, name):
    s = steps[name]
    for k in ("loss_d", "loss_g"):
        ref, got = s["metrics"][k], s["port_metrics"][k]
        assert np.isfinite(got) and abs(got - ref) <= 2e-2 * abs(ref), (k, ref, got)


@pytest.mark.parametrize("name", list(FLAGS))
def test_step_no_further_from_float32_than_twice_jax(steps, name):
    s = steps[name]
    port = _distance(_mu(s["step"]), s["ref"])
    jax_side = _distance(_jax_mu(s["new"]), s["ref"])
    print(f"{name}: distance from the port's float32 step: port {port:.4g}, JAX {jax_side:.4g}")
    assert 0 < port <= 2 * jax_side, (port, jax_side)


def _broken(index, factor):
    """A fused backward whose output `index` (dtheta, dphi, dg) is scaled."""
    plain = attention_mod.fused_attention_bwd

    def bwd(*args):
        out = list(plain(*args))
        out[index] = out[index] * factor
        return tuple(out)
    return bwd


def test_the_rule_skips_only_leaves_no_loss_reads():
    """chip_smoke's bf16 step rule skips the leaves whose float32 gradient in
    the same run, read off Adam's first moments, is at most 1e-6 of their
    side's largest. Under RSGAN the discriminator's head biases cancel in
    real - fake, and a conv's bias before a batch-statistics BatchNorm
    cancels in the normalisation: both are skipped; under the vanilla loss
    the head biases are held. A bf16 parameter copy used by several heads
    sums their gradients in bf16, as JAX sums a bf16 cotangent, which leaves
    a residue that depends on the order."""
    torch.manual_seed(0)
    step = _port_step((False, False, False))
    video, caps, lens = _batch()
    batch = {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
             "lengths": torch.from_numpy(lens)}
    step(batch)

    def gradients():
        """A float32 step's gradients as chip_smoke reads them off the first
        moments, after a step that left them nonzero."""
        start = chip_smoke.StateSnapshot(step)
        step(batch)
        grads = chip_smoke.adam_gradients(step, start)
        for side, module in (("G", step.gan.gen), ("D", step.gan.discrims[0])):
            for n, p in module.named_parameters():
                torch.testing.assert_close(grads[f"{side} {n}"], p.grad, rtol=1e-5, atol=1e-7)
        return grads

    inert = chip_smoke.loss_free_leaves(gradients())
    heads = {f"D discrim.{n}.bias" for n in ("fc", "fc_uncond")}
    before_bn = {f"G base.up{i}.conv{j}.bias" for i in range(3) for j in (1, 2)}
    assert heads | before_bn <= set(inert) and max(inert.values()) <= 1e-6
    step.losses = port_losses.VanillaGanLoss()
    assert not heads & set(chip_smoke.loss_free_leaves(gradients()))
    # one bf16 copy summing cancelling head gradients in two orders, here and
    # in JAX's autodiff of a bf16 cast
    vals = [4.7e-06, 0.01617, 0.02596]
    for order in (vals + [-v for v in vals], [v for x in vals for v in (x, -x)]):
        p = torch.zeros(1, requires_grad=True)
        copy = p.to(torch.bfloat16)
        sum((copy.float() * v).sum() for v in order).backward()
        def jax_loss(q):
            c = q.astype(BF)
            return sum(jnp.sum(c.astype(jnp.float32) * v) for v in order)
        ref = jax.grad(jax_loss)(jnp.zeros(1))
        assert (float(p.grad) != 0.0) == (float(ref[0]) != 0.0) == (order[1] > 0)


@pytest.mark.parametrize("broken", [None, (0, 0.0), (2, 0.9)],
                         ids=["kernels", "dtheta_zero", "dg_off_10pc"])
def test_chip_smoke_step_rule(monkeypatch, capsys, broken):
    """chip_smoke's in-step check of the bf16 kernels (compare_bf16_step)
    through the kernels' plain versions, which run for CPU tensors: it passes
    them, and fails a backward that zeroes dtheta or puts dg 10% off."""
    if broken is not None:
        monkeypatch.setattr(attention_mod, "fused_attention_bwd", _broken(*broken))
    torch.manual_seed(0)
    step = _port_step((True, True, False))
    video, caps, lens = _batch()
    batch = {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
             "lengths": torch.from_numpy(lens)}
    step(batch)
    if broken is None:
        chip_smoke.compare_bf16_step(step, batch, "bf16")
    else:
        with pytest.raises(SystemExit):
            chip_smoke.compare_bf16_step(step, batch, "bf16")
    with capsys.disabled():
        print(next(line for line in capsys.readouterr().out.splitlines()
                   if "leaf by leaf" in line))


@pytest.mark.parametrize("name", list(FLAGS))
def test_step_keeps_float32_masters_and_encoder(steps, name):
    bf16, nu, params = FLAGS[name]
    s = steps[name]
    step = s["step"]
    for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert s["encoded"] and set(s["encoded"]) == {torch.float32}
    # the step's forwards read bf16 weights with --bf16_params
    assert set(s["weights"]) == {torch.bfloat16 if params else torch.float32}
    for opt in (step.opt_g, step.opt_d):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert st["exp_avg_sq"].dtype == (torch.bfloat16 if nu else torch.float32)


# ----------------------------------------------------------------- checkpoints

def test_bf16_checkpoint_is_flax_bytes(steps, tmp_path):
    """The --bf16 --bf16_nu --bf16_params state after JAX's step, written by
    JAX's save_state, restored into the port and written back: the same bytes,
    mu and nu under flax's dtype name."""
    s = steps["bf16_nu_params"]
    path = str(tmp_path / "iter_1_jax")
    state = jax.tree_util.tree_map(jnp.asarray, s["new"])
    jax_checkpoint.save_state(state, path)
    step = _port_step(FLAGS["bf16_nu_params"])
    jax_state_to_torch(checkpoint.restore_state(torch_state_to_jax(step), path), step)
    out = checkpoint.save_state(torch_state_to_jax(step), tmp_path / "iter_1_port")
    with open(path, "rb") as f, open(out, "rb") as g:
        data = g.read()
        assert f.read() == data
    raw = serialization.msgpack_restore(data)
    assert raw["opt_g_state"]["0"]["mu"]["g"]["fc"]["kernel"].dtype == BF
    assert raw["opt_d_state"]["0"]["nu"]["d"]["0"]["discrim"]["fc"]["kernel"].dtype == BF


def test_checkpoints_restore_across_storage_dtypes(steps, tmp_path):
    """A bf16-moment checkpoint resumes under the float32 config (the moments'
    values exactly) and a float32 one under the bf16 config (rounded to
    nearest even), as r9's fallbacks need both ways."""
    bf16_step = steps["bf16_nu_params"]["step"]
    f32_step = steps["params_alone"]["step"]
    for src, flags in ((bf16_step, (False, False, False)), (f32_step, FLAGS["bf16_nu_params"])):
        path = checkpoint.save_state(torch_state_to_jax(src), tmp_path / f"iter_{flags}")
        dst = _port_step(flags)
        jax_state_to_torch(checkpoint.restore_state(torch_state_to_jax(dst), path), dst)
        want = torch.bfloat16 if flags[0] else torch.float32
        for (n, p), q in zip(src.gan.gen.named_parameters(), dst.gan.gen.parameters()):
            got = dst.opt_g.state[q]["exp_avg"]
            assert got.dtype == want, n
            assert torch.equal(got, src.opt_g.state[p]["exp_avg"].to(want)), n
            assert torch.equal(q, p), n


# --------------------------------------------------------------------- serving

def test_serve_bf16_matches_jax_service(tmp_path):
    """One JAX-written checkpoint served by txt2vid_tpu.serve with bf16=True
    and by the port's `from_checkpoint(bf16=True)`, each chunk at JAX's z."""
    vocab = JaxVocab()
    for w in WORDS:
        vocab.add_word(w)
    vocab_path = str(tmp_path / "vocab.pickle")
    import pickle
    with open(vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    from txt2vid_tpu.config import create_object as jax_create_object
    gan = JaxCondGan(gen=jax_create_object(SPEC_G, cond_dim=16),
                     discrims=[jax_create_object(SPEC_D, cond_dim=16)],
                     cond_encoder=jax_create_object(SPEC_S, vocab_size=len(vocab)))
    batch = {"video": np.zeros((4, 4, 32, 32, 3), np.float32),
             "captions": np.ones((4, 10), np.int32), "lengths": np.full((4,), 10, np.int32)}
    opt = optax.adam(1e-4)
    state = init_state_abstract(gan, jax.random.key(0), batch, opt, opt,
                                JaxTrainConfig(frame_sizes=(8, 16, 32), latent_size=16))
    rng = np.random.default_rng(50)
    state = state.replace(g_vars=random_variables(state.g_vars, rng),
                          txt_vars=random_variables(state.txt_vars, rng))
    path = str(tmp_path / "iter_0_lossG_0.0000_lossD_0.0000")
    jax_checkpoint.save_state(jax.tree_util.tree_map(jnp.asarray, state), path)
    kw = dict(sent=SPEC_S, vocab_path=vocab_path, frame_sizes=(8, 16, 32), num_frames=4,
              num_channels=3, batch_size=4, max_caption_len=10, bf16=True)
    jax_service = JaxService.from_checkpoint(path, SPEC_G, [SPEC_D], **kw)
    port = GeneratorService.from_checkpoint(path, SPEC_G, [SPEC_D], device="cpu", **kw)
    assert port.gan.gen.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.gan.gen.parameters())

    seed = 3
    ref_u8 = jax_service.generate(sentences=SENTENCES, seed=seed)
    u8s = []
    for i, (toks, lens) in enumerate(port._chunks(SENTENCES)[1]):
        # the JAX service's z for chunk i (serve.py:96-97)
        z = np.array(jax.random.normal(jax.random.fold_in(jax.random.key(seed), i), (4, 16)))
        assert port._video(toks, lens, z).dtype == torch.bfloat16
        u8s.append(port._run(toks, lens, z).numpy())
    got_u8 = np.concatenate(u8s)[:len(SENTENCES)]
    assert got_u8.dtype == np.uint8 and got_u8.shape == ref_u8.shape
    assert int(np.abs(got_u8.astype(int) - ref_u8.astype(int)).max()) <= 3
    assert ref_u8.std() > 5


def test_spec_dtype_names(tmp_path):
    """A spec's "dtype": "bfloat16" (or jnp's name, or a dtype object of that
    name) gives the port's modules torch.bfloat16."""
    from txt2vid_tpu_torch import config
    for name in ("bfloat16", "jnp.bfloat16", jnp.bfloat16, torch.bfloat16):
        g = config.create_object(json.dumps(
            {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
             "args": {**{k: v for k, v in GEN.items() if k != "cond_dim"}}}),
            cond_dim=16, dtype=name)
        assert g.dtype == torch.bfloat16 and g.up0.conv1.compute_dtype == torch.bfloat16
