"""`remat` in the port (models/tganv2.py, models/layers.remat) on the CPU.

- One train step of the small conditional TGANv2 with remat on, in G, in D
  or both, against the same step with remat off, from one state and one set
  of draws: losses, parameters and BatchNorm running statistics within 1e-6
  (the recomputation repeats the same float32 operations in the same order;
  measured equal). With the gradient penalty every second step, so the GP's
  double backward runs through the rematerialised discriminator. The same
  comparison with the statistics updated a second time in the recomputation
  fails.
- The remat generator against the JAX package's MultiScaleGen(remat=True),
  forward and parameter gradients (as tests/test_models.py's TestRemat holds
  the JAX remat to the JAX plain generator): 1e-5 of the scale for the
  rendered scales, 1e-4 of each leaf's scale (floored at 1e-2 of the largest)
  for the gradients.
- The recomputation takes the attention path its forward took: a
  discriminator forward under no_kernel() whose backward runs outside it.
- The attention launches per step that chip_smoke.py asserts, counted here
  through the wrappers' calls, with remat on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_models import assert_close, jax_variables
from test_torch_train_step import DISC, ENC, FRAME_SIZES, GEN, make_batch
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu_torch.convert import jax_to_torch_generator
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import layers, tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops import attention as port_attention
from txt2vid_tpu_torch.ops.initializers import init_from_seed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models run on one intra-op thread: beside other test
    processes, torch's thread pool oversubscribes the cores and runs many
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_step(remat_g, remat_d, gp_lambda=0.5):
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True, remat=remat_g), 1)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC, remat=remat_d), 2)
    enc = init_from_seed(Seq2Seq(**ENC), 3)
    with torch.no_grad():
        for m in list(gen.modules()) + list(disc.modules()):
            if hasattr(m, "gamma"):
                m.gamma.fill_(0.5)
    gan = CondGan(gen, enc, discrims=[disc])
    config = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                         latent_size=GEN["latent_size"], gp_lambda=gp_lambda, gp_every=2,
                         clip_grad=100.0)
    return build_train_step(gan, port_losses.RSGANLoss(), adam(gen.parameters()),
                            adam(disc.parameters()), config, seed=7)


def _batch():
    video, caps, lens = make_batch(1)
    return {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
            "lengths": torch.from_numpy(lens)}


def _run(remat_g, remat_d, steps=2):
    """Metrics of `steps` steps (a GP step, then a plain one) and the state."""
    step, batch = _port_step(remat_g, remat_d), _batch()
    metrics = [{k: float(v) for k, v in step(batch).items()} for _ in range(steps)]
    state = {f"G.{k}": v.clone() for k, v in step.gan.gen.state_dict().items()}
    state.update({f"D.{k}": v.clone() for k, v in step.gan.discrims[0].state_dict().items()})
    return metrics, state


@pytest.fixture(scope="module")
def plain_run():
    return _run(False, False)


def _assert_same(ref, got):
    (m_ref, s_ref), (m_got, s_got) = ref, got
    for a, b in zip(m_ref, m_got):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(a[k])), (k, a[k], b[k])
    assert s_ref.keys() == s_got.keys()
    stats = [k for k in s_ref if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 13
    for k in s_ref:
        err = float((s_ref[k].double() - s_got[k].double()).abs().max())
        assert err <= 1e-6 * max(1.0, float(s_ref[k].abs().max())), (k, err)


@pytest.mark.parametrize("remat_g,remat_d", [(True, False), (False, True), (True, True)],
                         ids=["G", "D", "both"])
def test_remat_step_equals_the_plain_step(plain_run, remat_g, remat_d):
    _assert_same(plain_run, _run(remat_g, remat_d))


def test_statistics_updated_twice_would_fail(plain_run, monkeypatch):
    """The guard is what keeps the statistics right: without it the
    recomputation updates the running statistics a second time."""
    def updating(kernels_off):
        return port_attention.kernel_disabled(kernels_off)

    monkeypatch.setattr(layers, "_recompute_context", updating)
    with pytest.raises(AssertionError, match="running_"):
        _assert_same(plain_run, _run(True, False))


def test_gp_double_backward_through_the_remat_discriminator():
    """The penalty and its parameter gradients (the double backward) with D
    rematerialised, against D without remat: 1e-6 of the scale."""
    video, caps, lens = make_batch(2)
    out = {}
    for remat in (False, True):
        disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC, remat=remat), 2)
        with torch.no_grad():
            disc.discrim.attn.gamma.fill_(0.5)
        gan = CondGan(None, discrims=[disc])
        real = [torch.from_numpy(video[::1 << i, ::1 << i, ::1 << (2 - i), ::1 << (2 - i)])
                .contiguous() for i in range(3)]
        fake = [torch.tanh(r + 0.3) for r in real]
        rng = np.random.default_rng(3)
        conds = [torch.from_numpy(rng.standard_normal((r.shape[0], 16)).astype(np.float32))
                 for r in real]
        alphas = [torch.from_numpy(rng.uniform(size=r.shape[0]).astype(np.float32))
                  for r in real]
        gp = gan.gradient_penalty(0, alphas, real, fake, conds, [c.flip(0) for c in conds])
        params = list(disc.parameters())
        grads = torch.autograd.grad(gp, params, allow_unused=True)
        out[remat] = (float(gp.detach()), [torch.zeros_like(p) if g is None else g
                                           for p, g in zip(params, grads)])
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    assert sum(bool(g.any()) for g in out[False][1]) > len(out[False][1]) // 2
    for a, b in zip(out[False][1], out[True][1]):
        assert float((a - b).abs().max()) <= 1e-6 * max(1.0, float(a.abs().max()))


def test_recompute_takes_the_forwards_attention_path(monkeypatch):
    """A forward under no_kernel() whose backward runs outside it recomputes
    through the plain attention: the recomputed saved tensors match (torch's
    check would raise otherwise), and no FusedAttention runs."""
    calls = []
    apply = port_attention.FusedAttention.apply
    monkeypatch.setattr(port_attention.FusedAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC, remat=True), 2)
    x = torch.from_numpy(make_batch(3)[0]).requires_grad_()
    with port_attention.no_kernel():
        u, _, _ = disc([x])[0]
        (dx,) = torch.autograd.grad(u.sum(), x, create_graph=True)
    dx.square().sum().backward()
    assert not calls and x.grad is not None
    u, _, _ = disc([x])[0]
    u.sum().backward()
    assert len(calls) == 2          # the forward and its recomputation


@pytest.mark.parametrize("remat_g,remat_d", [(False, False), (True, True), (True, False)],
                         ids=["off", "on", "G"])
def test_attention_launches_per_step(monkeypatch, remat_g, remat_d):
    """K1 and K2/K3 calls per step, GP and plain, as chip_smoke.train_launches
    counts them: 3 discriminator scales, one generator attention; remat off,
    in both models, and in G alone (the cond-128 command line's specs)."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = port_attention.fused_attention, port_attention.fused_attention_bwd

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_attention, "fused_attention", counting("fwd", fwd))
    monkeypatch.setattr(port_attention, "fused_attention_bwd", counting("bwd", bwd))
    step, batch = _port_step(remat_g, remat_d), _batch()
    want = chip_smoke.train_launches(len(FRAME_SIZES), remat_g, remat_d)
    for _ in range(2):              # a GP step, then a plain one
        counts.update(fwd=0, bwd=0)
        step(batch)
        assert counts == {"fwd": want["attention_fwd"], "bwd": want["attention_bwd_dq"]}
        assert want["attention_bwd_dq"] == want["attention_bwd_dkv"]


def test_remat_generator_matches_jax(monkeypatch):
    """The port's remat generator against JAX's MultiScaleGen(remat=True):
    the rendered scales of a train-mode forward with JAX's subsample phases,
    and the gradients of their sum of squares."""
    cfg = dict(latent_size=16, width=32, height=32, num_channels=3, fm_channels=32,
               additional_blocks=(32, 16), num_frames=4, cond_dim=16)
    gen = jax_tganv2_cond.MultiScaleGen(**cfg, use_pallas=False, remat=True)
    variables = jax_variables(gen, 61, jnp.zeros((4, 16)), jnp.zeros((4, 16)), train=True)
    rng = np.random.default_rng(62)
    z = rng.standard_normal((4, 16)).astype(np.float32)
    cond = rng.standard_normal((4, 16)).astype(np.float32)

    from txt2vid_tpu.models import tganv2 as jax_tganv2
    phases, original = [], jax_tganv2.subsample_video

    def recording(x, key, *args, **kwargs):
        out = original(x, key, *args, **kwargs)
        phases.append(out[1])
        return out

    monkeypatch.setattr(jax_tganv2, "subsample_video", recording)

    def loss(params):
        out, _ = gen.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(z), jnp.asarray(cond), train=True,
                           rngs={"sample": jax.random.key(63)}, mutable=["batch_stats"])
        return sum(jnp.sum(o ** 2) for o in out), (out, [jnp.asarray(p) for p in phases])

    (_, (ref, ph)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    port = tganv2.MultiScaleGen(**cfg, with_non_local=True, remat=True).train()
    port.load_state_dict(jax_to_torch_generator(variables["params"],
                                                variables["batch_stats"]))
    got = port(torch.from_numpy(z), torch.from_numpy(cond), train=True,
               phases=[int(p) for p in ph])
    for r, g in zip(ref, got):
        assert_close(r, g.detach(), 1e-5, "scale")
    sum(o.square().sum() for o in got).backward()
    ref_grads = jax_to_torch_generator(grads)
    port_grads = {n: p.grad for n, p in port.named_parameters()}
    assert ref_grads.keys() == port_grads.keys()
    # a conv bias before a BatchNorm has a zero gradient in exact arithmetic
    # and holds float noise: each leaf's scale is floored at 1e-2 of the largest
    top = max(float(r.abs().max()) for r in ref_grads.values())
    for n, r in ref_grads.items():
        scale = max(float(r.abs().max()), 1e-2 * top)
        assert float((r - port_grads[n]).abs().max()) <= 1e-4 * scale, n
