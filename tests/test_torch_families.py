"""The TCWYT, TGAN and image-GAN modules of txt2vid_tpu_torch, their layers and
TGANv2's no_lstm generator, against txt2vid_tpu's on the CPU.

Each JAX module gets a random variable tree (test_torch_models'
random_variables: BatchNorm statistics, scales and biases random too),
carried into the port with txt2vid_tpu_torch.convert, and both run on the
same numpy inputs, in eval mode and in train mode, where the running
statistics after the one forward are compared as well. Each JAX forward is
compiled once with jax.jit (op by op it is slower on the CPU).

Tolerances: 1e-5 * max(1, max|ref|) per module and 1e-4 per whole
generator in float32; 2e-2 for the bf16 forward of each family, 4e-2 for
the whole no_lstm TGANv2 generator (test_torch_bf16's whole-generator
tolerance). tgan.Gen runs at batch 3: at batch 2 the first BatchNorm of its
seed generator takes statistics over two values, where flax's fast variance
E[x^2] - E[x]^2 cancels (JAX measured 1.3e-2 from a float64 forward of the
same module, the port's two-pass variance 3.9e-5). Each
hazard of the port has a test that fails without its fix: the flipped
ConvTranspose kernel, flax's asymmetric SAME padding, the LayerNorm's
(H, W, C) layout, and no_lstm's float32 seed generator under bf16.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_models import assert_close, jax_variables
from txt2vid_tpu.models import img as jax_img
from txt2vid_tpu.models import tcwyt as jax_tcwyt
from txt2vid_tpu.models import tgan as jax_tgan
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu_torch.convert import (flax_to_module, jax_to_torch_generator,
                                       module_to_flax, torch_to_jax_generator)
from txt2vid_tpu_torch.models import img, layers, tcwyt, tgan, tganv2

BF = jnp.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def load(port, variables):
    port.load_state_dict(flax_to_module(port, variables["params"],
                                        variables.get("batch_stats")))
    return port


def compare(jax_mod, port, args, kwargs=None, train=False, tol=1e-5, seed=0,
            port_call=None, has_train=True, what=""):
    """jax_mod.apply vs the port module loaded with the same variables, in
    train or eval mode; in train mode the updated statistics too."""
    kwargs = kwargs or {}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    mode = {"train": True} if has_train else {}
    variables = jax_variables(jax_mod, seed, *jargs, **kwargs, **mode)
    if has_train:
        ref, updates = jax.jit(lambda v, *a: jax_mod.apply(
            v, *a, train=train, mutable=["batch_stats"], **kwargs))(variables, *jargs)
    else:
        ref, updates = jax.jit(lambda v, *a: jax_mod.apply(v, *a, **kwargs))(variables, *jargs), {}
    port = load(port, variables).train(train)
    targs = [None if a is None else t(a) for a in args]
    with torch.no_grad():
        got = port_call(port, *targs) if port_call else port(*targs)
    assert_close(ref, got, tol, what)
    if train and updates.get("batch_stats"):
        stats = module_to_flax(port)[1]
        flat_ref = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        assert flat_ref
        for path, r in flat_ref:
            node = stats
            for k in path:
                node = node[k.key]
            assert_close(r, node, 1e-5, f"{what} running statistic {path}")
    return variables, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("shape,cls", [((5, 6), layers.BatchNorm1d),
                                       ((5, 4, 6), layers.BatchNorm1d),
                                       ((2, 3, 4, 5, 6), layers.BatchNorm3d)],
                         ids=["bc", "bcl", "bcthw"])
def test_batch_norm(shape, cls, train):
    """flax's BatchNorm (momentum 0.9, biased variance) over the channel axis
    of (B, C), (B, C, L) and (B, C, T, H, W); x is channel-last for flax."""
    x = rand(shape, 1) * 2 + 0.5
    last = np.moveaxis(x, 1, -1) if x.ndim > 2 else x
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9)
    variables = jax_variables(bn, 2, jnp.asarray(last))
    ref, updates = bn.apply(variables, jnp.asarray(last), mutable=["batch_stats"])
    port = load(cls(shape[1], eps=1e-5), variables).train(train)
    with torch.no_grad():
        got = port(t(x))
    assert_close(ref, np.moveaxis(got.numpy(), 1, -1) if x.ndim > 2 else got, 1e-5, "BN")
    if train:
        assert_close(updates["batch_stats"]["mean"], port.running_mean, 1e-5, "mean")
        assert_close(updates["batch_stats"]["var"], port.running_var, 1e-5, "var")
        port.running_mean.zero_()
        with torch.no_grad(), layers.frozen_batch_stats():
            port(t(x))
        assert float(port.running_mean.abs().max()) == 0.0


TRANSPOSE_CASES = [((4, 4, 4), 2, "SAME"), ((2, 6, 6), 1, "VALID"), ((4,), 2, "SAME"),
                   ((3, 3), 1, "SAME"), ((4, 4), 2, "SAME")]


@pytest.mark.parametrize("kernel,stride,padding", TRANSPOSE_CASES,
                         ids=["444s2same", "266s1valid", "4s2same", "33s1same", "44s2same"])
def test_conv_transpose(kernel, stride, padding):
    """flax's ConvTranspose convolves with its kernel unflipped; the port's
    weight is it flipped, and with the kernel merely permuted the result
    differs (the hazard this pins)."""
    n = len(kernel)
    x = rand((2,) + (3,) * n + (5,), 3)
    conv = fnn.ConvTranspose(4, kernel, strides=(stride,) * n, padding=padding)
    variables = jax_variables(conv, 4, jnp.asarray(x))
    ref = conv.apply(variables, jnp.asarray(x))
    cls = {1: layers.ConvTranspose1d, 2: layers.ConvTranspose2d, 3: layers.ConvTranspose3d}[n]
    port = load(cls(5, 4, kernel, stride=stride, padding=padding), variables)
    xc = t(np.moveaxis(x, -1, 1))
    with torch.no_grad():
        got = np.moveaxis(port(xc).numpy(), 1, -1)
        k = t(np.asarray(variables["params"]["kernel"])).permute(n, n + 1, *range(n))
        unflipped = np.moveaxis(port._conv(xc, k, port.bias, port.stride, port.padding,
                                           port.output_padding).numpy(), 1, -1)
    assert_close(ref, got, 1e-5, "ConvTranspose")
    assert float(np.abs(np.asarray(ref) - unflipped).max()) > 1e-2


@pytest.mark.parametrize("size", [5, 6])
def test_same_conv_stride2(size):
    """flax's SAME at stride 2 with a 4-wide kernel: (1, 2) on an odd size,
    (1, 1) on an even one; with the odd element before, (2, 1), the odd
    case differs."""
    x = rand((2, size, size, 3), 5)
    conv = fnn.Conv(4, (4, 4), strides=2, padding="SAME", use_bias=False)
    variables = jax_variables(conv, 6, jnp.asarray(x))
    ref = conv.apply(variables, jnp.asarray(x))
    port = load(layers.SameConv2d(3, 4, 4, stride=2, bias=False), variables)
    xc = t(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = port(xc).permute(0, 2, 3, 1)
        lo, hi = (1, 2) if size % 2 else (1, 1)
        before = F.conv2d(F.pad(xc, (hi, lo, hi, lo)), port.weight, stride=2)
    assert_close(ref, got, 1e-5, "SameConv2d")
    diff = float(np.abs(np.asarray(ref) - before.permute(0, 2, 3, 1).numpy()).max())
    assert (diff > 1e-2) if size % 2 else (diff < 1e-5)


def test_layer_norm_over_hwc():
    """nn.LayerNorm over (H, W, C) with (H, W, C) scale and bias: the port's
    (C, H, W) parameters are their transposes; read as a reshape they are not."""
    x = rand((2, 3, 4, 5), 7) * 3 + 1
    ln = fnn.LayerNorm(reduction_axes=(-3, -2, -1), feature_axes=(-3, -2, -1), epsilon=1e-5)
    variables = jax_variables(ln, 8, jnp.asarray(x))
    ref = ln.apply(variables, jnp.asarray(x))
    port = load(layers.LayerNormCHW((5, 3, 4)), variables)
    with torch.no_grad():
        got = port(t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
        assert_close(ref, got, 1e-5, "LayerNorm")
        port.weight.copy_(t(np.asarray(variables["params"]["scale"]).reshape(5, 3, 4)))
        wrong = port(t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert float(np.abs(np.asarray(ref) - wrong.numpy()).max()) > 1e-2


def test_mean_pool():
    x = rand((2, 6, 4, 3), 9)
    assert_close(jax_img._mean_pool(jnp.asarray(x)),
                 img._mean_pool(t(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1), 1e-6, "pool")


MODES = pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])


# ------------------------------------------------------------------------ tgan

@MODES
def test_frame_seed_generator(train):
    compare(jax_tgan.FrameSeedGenerator(z_fast_dim=6), tgan.FrameSeedGenerator(5, 6),
            [rand((3, 5), 10)], train=train, seed=11, what="FrameSeedGenerator")


@MODES
def test_video_frame_generator(train):
    compare(jax_tgan.VideoFrameGenerator(3, 4, 32), tgan.VideoFrameGenerator(5, 6, 3, 4, 32),
            [rand((4, 5), 12), rand((4, 6), 13)], train=train, seed=14,
            what="VideoFrameGenerator")


@MODES
def test_tgan_gen(train):
    compare(jax_tgan.Gen(z_slow_dim=5, z_fast_dim=6, conv_ch=32),
            tgan.Gen(z_slow_dim=5, z_fast_dim=6, cond_dim=3, conv_ch=32),
            [rand((3, 5), 15), rand((3, 3), 16)], train=train, tol=1e-4, seed=17,
            port_call=lambda m, z, c: m(z, c, train=train), what="tgan.Gen")


# ----------------------------------------------------------------------- tcwyt

@MODES
def test_tcwyt_gen(train):
    _, port = compare(jax_tcwyt.Gen(z_size=6, scale_factor=1 / 16),
                      tcwyt.Gen(z_size=6, cond_dim=4, scale_factor=1 / 16),
                      [rand((3, 6), 18), rand((3, 4), 19)], train=train, tol=1e-4, seed=20,
                      port_call=lambda m, z, c: m(z, c, train=train), what="tcwyt.Gen")
    assert port(t(rand((3, 6), 18)), t(rand((3, 4), 19))).shape == (3, 16, 48, 48, 3)


@MODES
@pytest.mark.parametrize("cond", [True, False], ids=["cond", "uncond"])
def test_video_discrim(cond, train):
    """40 px: each SAME stride-2 layer on an odd size pads the odd element
    after (20 -> 10 -> 5 -> 3)."""
    x, c = rand((3, 8, 40, 40, 3), 21), rand((3, 8), 22)
    _, port = compare(jax_tcwyt.VideoDiscrim(cond_dim=8, mid_ch=4), tcwyt.VideoDiscrim(
        cond_dim=8 if cond else 0, mid_ch=4), [x], {"cond": jnp.asarray(c)} if cond else {},
        train=train, seed=23, port_call=lambda m, v: m(v, cond=t(c) if cond else None),
        what="VideoDiscrim")
    with pytest.raises(ValueError, match="cond"):
        port(t(x), cond=None if cond else t(c))


@MODES
def test_frame_map(train):
    """40-px frames -> (B, T, 3, 3, 512): the last SAME stride-2 conv on 5."""
    compare(jax_tcwyt.FrameMap(), tcwyt.FrameMap(), [rand((2, 3, 40, 40, 3), 24)],
            train=train, seed=25, what="FrameMap")


@MODES
@pytest.mark.parametrize("name", ["FrameDiscrim", "MotionDiscrim"])
def test_frame_and_motion_discrim(name, train):
    """The heads on 3x3 maps: pred1 (2x2, stride 2, VALID) gives 1x1."""
    xbar, c = rand((2, 3, 3, 3, 512), 26), rand((2, 8), 27)
    _, port = compare(getattr(jax_tcwyt, name)(cond_dim=8), getattr(tcwyt, name)(cond_dim=8),
                      [], {"xbar": jnp.asarray(xbar), "cond": jnp.asarray(c)}, train=train,
                      seed=28, port_call=lambda m: m(xbar=t(xbar), cond=t(c)), what=name)
    assert port(xbar=t(xbar), cond=t(c)).shape == ((2, 3) if name == "FrameDiscrim" else (2, 2))


# ------------------------------------------------------------------------- img

@MODES
def test_residual_block_up(train):
    compare(jax_img.ResidualBlockUp(4), img.ResidualBlockUp(8, 4), [rand((2, 4, 4, 8), 29)],
            train=train, seed=30, what="ResidualBlockUp",
            port_call=lambda m, x: m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


def test_residual_block_down():
    compare(jax_img.ResidualBlockDown(8), img.ResidualBlockDown(4, 8, 8),
            [rand((2, 8, 8, 4), 31)], seed=32, has_train=False, what="ResidualBlockDown",
            port_call=lambda m, x: m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


@MODES
def test_img_gen(train):
    compare(jax_img.Gen(dim=4), img.Gen(dim=4), [rand((2, 128), 33)], train=train, tol=1e-4,
            seed=34, port_call=lambda m, z: m(z, train=train), what="img.Gen")


def test_img_discrim():
    """No BatchNorm (train and eval are one); the last Dense in float32."""
    _, port = compare(jax_img.Discrim(dim=4), img.Discrim(dim=4),
                      [rand((2, 64, 64, 3), 35)], seed=36, what="img.Discrim")
    assert port.ln1.compute_dtype is None


# --------------------------------------------------------------- TGANv2 no_lstm

NO_LSTM = dict(latent_size=8, width=32, height=32, num_channels=3, fm_channels=16,
               additional_blocks=(16, 8), num_frames=4, cond_dim=8, no_lstm=True)


def no_lstm_pair(dtype=None):
    gen = jax_tganv2.MultiScaleGen(**NO_LSTM, with_non_local=True, use_pallas=False,
                                   dtype=None if dtype is None else BF)
    variables = jax_variables(gen, 37, jnp.zeros((4, 8)), jnp.zeros((4, 8)), train=True)
    port = tganv2.MultiScaleGen(**NO_LSTM, with_non_local=True, dtype=dtype)
    port.load_state_dict(jax_to_torch_generator(variables["params"],
                                                variables["batch_stats"]))
    return gen, variables, port


@MODES
def test_no_lstm_generator(train, monkeypatch):
    """The no_lstm generator in both modes (train: the subsample phases JAX
    drew, recorded), its statistics after a train forward, and its tree
    through the generator's path map both ways."""
    gen, variables, port = no_lstm_pair()
    assert "frame_seed_gen" in variables["params"]
    z, c = rand((4, 8), 38), rand((4, 8), 39)
    phases = []

    def recording(v, key, *a, **k):
        out = subsample(v, key, *a, **k)
        phases.append(out[1])
        return out

    def run(v, z, c):
        phases.clear()
        ref, updates = gen.apply(v, z, c, train=train, rngs={"sample": jax.random.key(3)},
                                 mutable=["batch_stats"])
        return ref, updates, list(phases)

    subsample = jax_tganv2.subsample_video
    monkeypatch.setattr(jax_tganv2, "subsample_video", recording)
    ref, updates, drawn = jax.jit(run)(variables, jnp.asarray(z), jnp.asarray(c))
    port.train(train)
    with torch.no_grad():
        got = port(t(z), t(c), train=train,
                   phases=[int(p) for p in drawn] if train else None)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert_close(r, g, 1e-4, "no_lstm MultiScaleGen")
    params, stats = torch_to_jax_generator(port.state_dict())
    if train:
        for path, r in jax.tree_util.tree_leaves_with_path(updates["batch_stats"]):
            node = stats
            for k in path:
                node = node[k.key]
            assert_close(r, node, 1e-5, f"statistic {path}")
    back = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, back, jax.tree_util.tree_map(np.asarray, variables["params"])))


# ------------------------------------------------------------------------ bf16

def test_no_lstm_seed_generator_is_float32_under_bf16():
    """In JAX frame_seed_gen gets no dtype, so under bf16 it computes in
    float32 from the bf16 fc output; the port's too, and the whole bf16
    forward agrees to test_torch_bf16's 4e-2 for a whole generator."""
    gen, variables, port = no_lstm_pair(torch.bfloat16)
    seen = []
    port.frame_seed_gen.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    z, c = rand((4, 8), 40), rand((4, 8), 41)
    ref = jax.jit(lambda v, z, c: gen.apply(v, z, c, train=False))(
        variables, jnp.asarray(z), jnp.asarray(c))
    with torch.no_grad():
        got = port.eval()(t(z), t(c), train=False)
    assert seen == [(torch.bfloat16, torch.float32)]
    assert ref[-1].dtype == BF and got[-1].dtype == torch.bfloat16
    assert_close(np.asarray(ref[-1].astype(jnp.float32)), got[-1].float(), 4e-2, "bf16 no_lstm")


@pytest.mark.parametrize("family", ["tcwyt", "tgan", "img"])
def test_bf16_forward(family):
    """One bf16 forward per family against the JAX module with
    dtype=bfloat16, in eval mode. (In train mode, batch statistics over a
    few samples of bf16 values put both sides far from a float64 forward of
    the same module: tgan.Gen at batch 2 measured 0.20 (JAX) and 0.29 (port)
    from it, in eval mode 3.1e-3 and 3.4e-3.)"""
    if family == "tcwyt":
        pair = (jax_tcwyt.Gen(z_size=6, scale_factor=1 / 16, dtype=BF),
                tcwyt.Gen(z_size=6, cond_dim=4, scale_factor=1 / 16, dtype=torch.bfloat16))
        args = [rand((3, 6), 42), rand((3, 4), 43)]
    elif family == "tgan":
        pair = (jax_tgan.Gen(z_slow_dim=5, z_fast_dim=6, conv_ch=32, dtype=BF),
                tgan.Gen(z_slow_dim=5, z_fast_dim=6, cond_dim=3, conv_ch=32,
                         dtype=torch.bfloat16))
        args = [rand((2, 5), 44), rand((2, 3), 45)]
    else:
        pair = (jax_img.Discrim(dim=4, dtype=BF), img.Discrim(dim=4, dtype=torch.bfloat16))
        args = [rand((2, 64, 64, 3), 46)]
    jax_mod, port = pair
    jargs = [jnp.asarray(a) for a in args]
    variables = jax_variables(jax_mod, 47, *jargs, train=True)
    ref, _ = jax.jit(lambda v, *a: jax_mod.apply(v, *a, train=False, mutable=["batch_stats"]))(
        variables, *jargs)
    port = load(port, variables).eval()
    with torch.no_grad():
        got = port(*[t(a) for a in args])
    assert got.dtype == (torch.float32 if family == "img" else torch.bfloat16)
    assert_close(np.asarray(jnp.asarray(ref).astype(jnp.float32)), got.float(), 2e-2,
                 f"bf16 {family}")
