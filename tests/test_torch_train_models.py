"""The training slice's models in txt2vid_tpu_torch against txt2vid_tpu on the
CPU: the discriminator's blocks (Attention3d, DownBlock, Resnet3D with both
cond heads, MultiScaleDiscrim), the generator in train mode, and the loss zoo.

Variables are random with nothing at its init value (test_torch_models'
`random_variables`: attention gammas nonzero, biases random), carried into the
port with txt2vid_tpu_torch.convert. The JAX attention runs its Pallas kernels
in interpret mode. Gradients are taken of sum(output * w) for a random w, with
respect to every parameter and the input, on both sides.
Tolerances: forwards 1e-5 * max(1, max|ref|) (2e-5 through attention);
gradients 1e-4 * the leaf's max|grad|; the generator's scales and BatchNorm
running statistics 1e-5 * scale; losses and their gradients 1e-6 * scale.
Torch runs on one intra-op thread (beside other test processes its thread
pool oversubscribes the cores). There the generator's train-mode scales,
through its first BatchNorm over the ConvLSTM's 1x1 output, sit 1.1e-5 of
their scale from JAX's: both sides' scales are held to the port's float64
forward of the same variables and phases instead, the port's within 1e-5
(measured 6.3e-6) and JAX's within 2e-5, the tolerance through attention
(measured 1.04e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (SMALL_GEN, assert_close, jax_variables, pallas_interpret,
                               small_generator)
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.models import layers as jax_layers
from txt2vid_tpu.models import resnet3d as jax_resnet3d
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu_torch.convert import jax_to_torch_discriminator, jax_to_torch_generator
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.models import layers, resnet3d, tganv2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def port_disc_state(prefix, params):
    """Convert a lone discriminator block's params by nesting them where
    Resnet3D keeps such a block (`discrim/<prefix>`) and stripping that again."""
    sd = jax_to_torch_discriminator({"discrim": {prefix: params} if prefix else params})
    strip = len("discrim.") + (len(prefix) + 1 if prefix else 0)
    return {k[strip:]: v for k, v in sd.items()}


def jax_grads(module, variables, inputs, weights, **kwargs):
    """Gradients of sum(out_i * w_i) over the module's outputs with respect to
    the params and the inputs, compiled once, Pallas in interpret mode."""
    def loss(params, *xs):
        out = module.apply({**variables, "params": params}, *xs, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights) if w is not None)

    with pallas_interpret():
        return jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs) + 1))))(
            variables["params"], *inputs)


def assert_grads_close(ref_params, port_module, prefix, tol=1e-4):
    ref = port_disc_state(prefix, ref_params)
    got = {n: p.grad for n, p in port_module.named_parameters()}
    assert set(ref) == set(got)
    for name, r in ref.items():
        scale = float(r.abs().max())
        err = float((r - got[name]).abs().max())
        assert err <= tol * scale, f"grad {name}: {err} > {tol} * {scale}"


class TestDiscriminatorBlocks:
    def test_attention3d(self):
        # 128 channels: d = 16, dv = 64; N = 4*4*4, M = 4*2*2
        rng = np.random.default_rng(40)
        x = rng.standard_normal((2, 4, 4, 4, 128)).astype(np.float32)
        w = rng.standard_normal(x.shape).astype(np.float32)
        block = jax_layers.Attention3d(128, use_pallas=True)
        variables = jax_variables(block, 41, jnp.asarray(x))
        assert float(variables["params"]["gamma"]) != 0.0
        with pallas_interpret():
            ref = jax.jit(block.apply)(variables, jnp.asarray(x))
        port = layers.Attention3d(128)
        port.load_state_dict(port_disc_state("attn", variables["params"]))
        xt = to_ncdhw(x).requires_grad_()
        out = port(xt)
        assert_close(ref, out.permute(0, 2, 3, 4, 1), 2e-5, "Attention3d")
        (out * to_ncdhw(w)).sum().backward()
        g_params, g_x = jax_grads(block, variables, [jnp.asarray(x)], [w])
        assert_grads_close(g_params, port, "attn")
        assert_close(g_x, xt.grad.permute(0, 2, 3, 4, 1), 1e-4, "dx")

    @pytest.mark.parametrize("wide", [False, True])
    def test_down_block(self, wide):
        rng = np.random.default_rng(42)
        x = rng.standard_normal((2, 4, 6, 5, 16)).astype(np.float32)   # odd W pads
        block = jax_layers.DownBlock(16, 32, wide=wide)
        variables = jax_variables(block, 43, jnp.asarray(x))
        ref = jax.jit(block.apply)(variables, jnp.asarray(x))
        w = rng.standard_normal(ref.shape).astype(np.float32)
        port = layers.DownBlock(16, 32, wide=wide)
        port.load_state_dict(port_disc_state("down0", variables["params"]))
        xt = to_ncdhw(x).requires_grad_()
        out = port(xt)
        assert_close(ref, out.permute(0, 2, 3, 4, 1), 1e-5, "DownBlock")
        (out * to_ncdhw(w)).sum().backward()
        g_params, g_x = jax_grads(block, variables, [jnp.asarray(x)], [w])
        assert_grads_close(g_params, port, "down0")
        assert_close(g_x, xt.grad.permute(0, 2, 3, 4, 1), 1e-4, "dx")

    @pytest.mark.parametrize("cond_head", ["concat", "proj"])
    def test_resnet3d(self, cond_head):
        rng = np.random.default_rng(44)
        # down0's output is 1 x 4 x 4, so Attention3d has N = 16, M = 4 (at
        # M = 1 the softmax is constant and theta/phi get no gradient)
        x = rng.uniform(-1, 1, (3, 4, 16, 16, 3)).astype(np.float32)
        cond = rng.standard_normal((3, 8)).astype(np.float32)
        kw = dict(num_channels=3, cond_dim=8, num_down_blocks=2, cond_head=cond_head)
        net = jax_resnet3d.Resnet3D(**kw, use_pallas=True)
        variables = jax_variables(net, 45, jnp.asarray(x), jnp.asarray(cond))
        with pallas_interpret():
            ref = jax.jit(net.apply)(variables, jnp.asarray(x), jnp.asarray(cond))
        port = resnet3d.Resnet3D(**kw)
        port.load_state_dict(port_disc_state("", variables["params"]))
        xt = torch.from_numpy(x).requires_grad_()
        out = port(xt, torch.from_numpy(cond))
        for what, r, p in zip(("uncond", "cond", "features"), ref, out):
            assert_close(r, p, 2e-5, what)
        w = [rng.standard_normal(r.shape).astype(np.float32) for r in ref[:2]]
        sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(out[:2], w)).backward()
        g_params, g_x, _ = jax_grads(net, variables, [jnp.asarray(x), jnp.asarray(cond)],
                                     w + [None])
        assert_grads_close(g_params, port, "")
        assert_close(g_x, xt.grad, 1e-4, "dx")
        # the backbone skipped: the cond head over given features, no uncond
        u, c, f = port(cond=torch.from_numpy(cond), computed_features=out[2])
        assert u is None and torch.allclose(c, out[1]) and f is out[2]

    @pytest.mark.parametrize("single", [True, False])
    def test_multiscale_discrim(self, single):
        rng = np.random.default_rng(46)
        xs = [rng.uniform(-1, 1, (4 >> i, 4 >> i, 16 << i, 16 << i, 3)).astype(np.float32)
              for i in range(2)]
        conds = [rng.standard_normal((4 >> i, 8)).astype(np.float32) for i in range(2)]
        kw = dict(discrim_down_blocks=(1, 2), cond_dim=8, single_discrim=single)
        net = jax_tganv2.MultiScaleDiscrim(**kw, use_pallas=True)
        jx, jc = [jnp.asarray(x) for x in xs], [jnp.asarray(c) for c in conds]
        variables = jax_variables(net, 47, jx, cond=jc)
        with pallas_interpret():
            ref = jax.jit(lambda v, x, c: net.apply(v, x, cond=c))(variables, jx, jc)
        port = tganv2.MultiScaleDiscrim(**kw)
        port.load_state_dict(jax_to_torch_discriminator(variables["params"]))
        xts = [torch.from_numpy(x).requires_grad_() for x in xs]
        out = port(xts, cond=[torch.from_numpy(c) for c in conds])
        assert len(out) == len(ref) == 2
        for r_scale, p_scale in zip(ref, out):
            for what, r, p in zip(("uncond", "cond", "features"), r_scale, p_scale):
                assert_close(r, p, 2e-5, what)
        sum(u.sum() + c.sum() for u, c, _ in out).backward()

        def loss(params, x):
            out = net.apply({"params": params}, x, cond=jc)
            return sum(jnp.sum(u) + jnp.sum(c) for u, c, _ in out)

        with pallas_interpret():
            g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jx)
        ref_grads = jax_to_torch_discriminator(g_params)
        for name, p in port.named_parameters():
            scale = float(ref_grads[name].abs().max())
            assert float((ref_grads[name] - p.grad).abs().max()) <= 1e-4 * scale, name
        for r, p in zip(g_x, xts):
            assert_close(r, p.grad, 1e-4, "dx")


class TestGeneratorTrainMode:
    def test_every_scale_and_running_stats(self, monkeypatch):
        """train=True with the JAX draw's subsample phases pinned: every
        rendered scale, both sides against the port's float64 forward, and
        the BatchNorm running statistics after one forward (flax: 0.9 * old
        + 0.1 * batch, biased variance) against JAX's."""
        import copy
        phases, original = [], jax_tganv2.subsample_video

        def recording(x, key, *args, **kwargs):
            out = original(x, key, *args, **kwargs)
            phases.append(int(out[1]))
            return out

        gen, variables, port = small_generator(48)
        monkeypatch.setattr(jax_tganv2, "subsample_video", recording)
        rng = np.random.default_rng(49)
        z = rng.standard_normal((4, 16)).astype(np.float32)
        cond = rng.standard_normal((4, 16)).astype(np.float32)
        with pallas_interpret():
            ref, updates = gen.apply(variables, jnp.asarray(z), jnp.asarray(cond),
                                     train=True, rngs={"sample": jax.random.key(50)},
                                     mutable=["batch_stats"])
        assert len(phases) == 2
        port64 = copy.deepcopy(port).double().train()
        port.train()
        with torch.no_grad():
            got = port(torch.from_numpy(z), torch.from_numpy(cond), train=True, phases=phases)
            monkeypatch.setattr(layers, "attention_core_auto", lambda t, p, g, use_kernel=True:
                                torch.softmax(t @ p.transpose(1, 2), dim=-1) @ g)
            want = port64(torch.from_numpy(z).double(), torch.from_numpy(cond).double(),
                          train=True, phases=phases)
        assert [tuple(r.shape) for r in ref] == [tuple(g.shape) for g in got] == \
            [(4, 4, 8, 8, 3), (2, 2, 16, 16, 3), (1, 1, 32, 32, 3)]
        for w, r, g in zip(want, ref, got):
            print("scale vs float64: jax %.3g, port %.3g" % (
                float(np.abs(np.asarray(r) - w.numpy()).max()), float((g - w).abs().max())))
            assert_close(w, r, 2e-5, "JAX's scale")
            assert_close(w, g, 1e-5, "the port's scale")
        stats = jax_to_torch_generator(variables["params"], updates["batch_stats"])
        before = jax_to_torch_generator(variables["params"], variables["batch_stats"])
        port_sd = port.state_dict()
        names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
        assert len(names) == 2 * 13
        for k in names:
            assert not torch.equal(stats[k], before[k])
            assert_close(stats[k].numpy(), port_sd[k], 1e-5, k)

    def test_train_flag_must_match_the_module_mode(self):
        port = tganv2.MultiScaleGen(**SMALL_GEN)
        with pytest.raises(ValueError, match="eval"):
            port.eval()(torch.zeros(2, 16), torch.zeros(2, 16), train=True)
        with pytest.raises(ValueError, match="training"):
            port.train()(torch.zeros(2, 16), torch.zeros(2, 16), train=False)


# (JAX loss, port loss) pairs, the whole zoo
LOSSES = [
    (jax_losses.VanillaGanLoss(), port_losses.VanillaGanLoss()),
    (jax_losses.HingeGanLoss(), port_losses.HingeGanLoss()),
    (jax_losses.WassersteinGanLoss(), port_losses.WassersteinGanLoss()),
    (jax_losses.RSGANLoss(), port_losses.RSGANLoss()),
    (jax_losses.RaSGANLoss(), port_losses.RaSGANLoss()),
    (jax_losses.RaLSGANLoss(), port_losses.RaLSGANLoss()),
    (jax_losses.MixedGanLoss(g_loss=jax_losses.RSGANLoss(), d_loss=jax_losses.HingeGanLoss()),
     port_losses.MixedGanLoss(g_loss=port_losses.RSGANLoss(),
                              d_loss=port_losses.HingeGanLoss())),
]


@pytest.mark.parametrize("which", ["discrim_loss", "gen_loss"])
@pytest.mark.parametrize("pair", LOSSES, ids=lambda p: type(p[1]).__name__)
def test_loss_value_and_gradient(pair, which):
    jax_loss, port_loss = pair
    rng = np.random.default_rng(51)
    fake = (2 * rng.standard_normal((6, 1))).astype(np.float32)
    real = (2 * rng.standard_normal((6, 1))).astype(np.float32)
    fn = getattr(jax_loss, which)
    ref, (g_fake, g_real) = jax.value_and_grad(
        lambda f, r: fn(fake=f, real=r), argnums=(0, 1))(jnp.asarray(fake), jnp.asarray(real))
    f, r = torch.from_numpy(fake).requires_grad_(), torch.from_numpy(real).requires_grad_()
    got = getattr(port_loss, which)(fake=f, real=r)
    assert got.dtype == torch.float32 and got.shape == ()
    got.backward()
    assert_close(ref, got, 1e-6, "value")
    assert_close(g_fake, f.grad if f.grad is not None else torch.zeros_like(f), 1e-6, "dfake")
    assert_close(g_real, r.grad if r.grad is not None else torch.zeros_like(r), 1e-6, "dreal")


def test_unmapped_discriminator_key_raises():
    with pytest.raises(KeyError, match="mystery"):
        jax_to_torch_discriminator({"discrim": {"mystery": {"kernel": np.zeros((2, 2))}}})
