"""The port's gradient penalty, in-step clip, GP quarantine and generator EMA
against the JAX package's functions, on the CPU.

- gradient_penalty and multiscale_gradient_penalty at fixed alpha (JAX's
  draws from its key, handed to the port): the penalty and its gradient
  w.r.t. the discriminator's parameters (a double backward), 1e-5 of the
  scale for the value, 1e-4 of the leaf's largest gradient;
- the penalty through the fused attention without no_kernel() raises
  instead of returning a second-order gradient;
- clip_by_norm_ (_clip_by_norm) on finite and infinite norms, then Adam on
  the clipped or zeroed gradients against optax.adam (clipped gradients 1e-6
  relative; moments and parameters 1e-5, the last bits of float32 updates);
- quarantine_nonfinite_ (_quarantine_nonfinite): the zeroed leaves and count;
- make_ema_update against JAX's (1e-6 of the scale, float32 lerp orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import jax_variables
from test_torch_train_step import DISC, GEN, scaled_kernels
from txt2vid_tpu.gan import ema as jax_ema
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan import train_step as jax_train_step
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu_torch.convert import (jax_to_torch_discriminator, jax_to_torch_generator,
                                       torch_to_jax_generator)
from txt2vid_tpu_torch.gan import ema
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import (adam, clip_by_norm_, global_norm,
                                              quarantine_nonfinite_)
from txt2vid_tpu_torch.models import tganv2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models run on one intra-op thread: beside other test
    processes, torch's thread pool oversubscribes the cores and runs many
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, S = 4, 3


def _scales(rng):
    real = [rng.uniform(-1, 1, (B >> s, 8 >> s, 8 << s, 8 << s, 3)).astype(np.float32)
            for s in range(S)]
    fake = [rng.uniform(-1, 1, r.shape).astype(np.float32) for r in real]
    conds = [rng.normal(size=(B >> s, DISC["cond_dim"])).astype(np.float32) for s in range(S)]
    fconds = [rng.normal(size=c.shape).astype(np.float32) for c in conds]
    return real, fake, conds, fconds


@pytest.fixture(scope="module")
def discrims():
    jd = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False)
    scales = [jnp.zeros((B >> s, 8 >> s, 8 << s, 8 << s, 3)) for s in range(S)]
    conds = [jnp.zeros((B >> s, DISC["cond_dim"])) for s in range(S)]
    d_vars = scaled_kernels(jax_variables(jd, 2, scales, cond=conds, train=True))
    pd = tganv2.MultiScaleDiscrim(**DISC)
    pd.load_state_dict(jax_to_torch_discriminator(d_vars["params"]))
    return jd, d_vars, pd


def test_multiscale_gradient_penalty_and_its_gradient(discrims):
    jd, d_vars, pd = discrims
    real, fake, conds, fconds = _scales(np.random.default_rng(0))
    key = jax.random.key(3)
    keys = jax.random.split(key, S)
    alphas = [np.asarray(jax.random.uniform(keys[s], (B >> s, 1, 1, 1, 1))).reshape(-1)
              for s in range(S)]

    def jax_gp(params):
        def d_fn_for_scale(si):
            def fn(x, cond, xbar):
                out, _ = jd.apply({"params": params}, [x], cond=[cond], train=True,
                                  scale_indices=[si], mutable=["batch_stats"])
                return out[0][0], out[0][1]
            return fn
        return jax_losses.multiscale_gradient_penalty(
            d_fn_for_scale, key, [jnp.asarray(r) for r in real],
            [jnp.asarray(f) for f in fake], real_conds=[jnp.asarray(c) for c in conds],
            fake_conds=[jnp.asarray(c) for c in fconds])

    ref, ref_grads = jax.jit(jax.value_and_grad(jax_gp))(d_vars["params"])
    gan = CondGan(None, discrims=[pd])
    got = gan.gradient_penalty(0, [torch.from_numpy(a) for a in alphas],
                               [torch.from_numpy(r) for r in real],
                               [torch.from_numpy(f) for f in fake],
                               [torch.from_numpy(c) for c in conds],
                               [torch.from_numpy(c) for c in fconds])
    pd.zero_grad()
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)), (float(got), float(ref))
    want = jax_to_torch_discriminator(jax.tree_util.tree_map(np.asarray, ref_grads))
    top = max(float(v.abs().max()) for v in want.values())
    for n, p in pd.named_parameters():
        # the penalty does not reach the last layers' biases: None here, 0 in JAX
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((grad - want[n]).abs().max())
        assert err <= 1e-4 * top, (n, err, top)


def test_gradient_penalty_single_scale_mean_form():
    """(||g|| - 1)^2 averaged, through a small nonlinear critic of x and cond."""
    rng = np.random.default_rng(1)
    x_r, x_f = (rng.normal(size=(3, 5, 4)).astype(np.float32) for _ in range(2))
    c_r, c_f = (rng.normal(size=(3, 6)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(20, 6)).astype(np.float32)
    key = jax.random.key(7)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1))).reshape(-1)

    def jax_gp(w):
        def d_fn(x, cond, xbar):
            h = jnp.tanh(x.reshape(3, -1) @ w)
            return h.sum(-1, keepdims=True), (h * cond).sum(-1, keepdims=True)
        return jax_losses.gradient_penalty(d_fn, key, jnp.asarray(x_r), jnp.asarray(x_f),
                                           real_cond=jnp.asarray(c_r),
                                           fake_cond=jnp.asarray(c_f))

    ref, ref_grad = jax.value_and_grad(jax_gp)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()

    def d_fn(x, cond):
        h = torch.tanh(x.reshape(3, -1) @ tw)
        return h.sum(-1, keepdim=True), (h * cond).sum(-1, keepdim=True)

    got = port_losses.gradient_penalty(d_fn, torch.from_numpy(alpha), torch.from_numpy(x_r),
                                       torch.from_numpy(x_f), torch.from_numpy(c_r),
                                       torch.from_numpy(c_f))
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_grad), rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref_grad).max()))


def test_penalty_through_the_fused_attention_raises(discrims):
    """Without no_kernel() the discriminator's attention goes through
    FusedAttention, which has no second-order gradient: the penalty raises
    rather than return a number that drops that term."""
    _, _, pd = discrims
    real, fake, conds, fconds = _scales(np.random.default_rng(2))

    def d_fn(x, cond):
        u, c, _ = pd([x], cond=[cond], scale_indices=[0])[0]
        return u, c

    with pytest.raises(RuntimeError, match="second-order"):
        port_losses.gradient_penalty(d_fn, torch.rand(B), torch.from_numpy(real[0]),
                                     torch.from_numpy(fake[0]), torch.from_numpy(conds[0]),
                                     torch.from_numpy(fconds[0]), zero_center=True)


def _tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("case", ["clips", "under", "inf", "nan"])
def test_clip_then_adam_matches_optax(case):
    """One Adam step on finite gradients, then the clip of `case` and a
    second step: the clipped gradients, both moments, the count and the
    parameters agree with _clip_by_norm and optax.adam."""
    rng = np.random.default_rng(3)
    params, g1, g2 = _tree(rng), _tree(rng), _tree(rng)
    if case == "inf":
        g2["a"][1, 2] = np.inf
    if case == "nan":
        g2["b"][0] = np.nan
    clip = {"clips": 0.5, "under": 1e3, "inf": 0.5, "nan": 0.5}[case]

    opt = optax.adam(2e-4, b1=0.5, b2=0.999)
    state = opt.init(params)
    p_j = params
    for g in (g1, g2):
        norm = optax.global_norm(g)
        g = jax_train_step._clip_by_norm(g, norm, clip)
        upd, state = opt.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
    clipped_j = g

    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    topt = adam(list(tp.values()))
    for g in (g1, g2):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        grads = [p.grad for p in tp.values()]
        clip_by_norm_(grads, global_norm(grads), clip)
        topt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(clipped_j[k]), rtol=1e-6)
        st = topt.state[p]
        assert int(st["step"]) == int(state[0].count) == 2
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(state[0].mu[k]),
                                   rtol=1e-5)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(state[0].nu[k]),
                                   rtol=1e-5)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]), rtol=1e-5)
    if case in ("inf", "nan"):
        assert all(float(p.grad.abs().max()) == 0.0 for p in tp.values())


def test_quarantine_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(3,)).astype(np.float32),
            "b": rng.normal(size=(2, 2)).astype(np.float32),
            "c": rng.normal(size=(4,)).astype(np.float32),
            "d": rng.normal(size=(1,)).astype(np.float32)}
    tree["a"][1] = np.inf
    tree["c"][3] = np.nan
    ref, n_ref = jax_train_step._quarantine_nonfinite(tree)
    got = [torch.from_numpy(v.copy()) for v in tree.values()]
    n = quarantine_nonfinite_(got)
    assert int(n) == int(n_ref) == 2 and n.dtype == torch.int32
    for g, k in zip(got, tree):
        np.testing.assert_array_equal(g.numpy(), np.asarray(ref[k]))


def test_ema_update_matches_jax():
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    avg = ema.init_ema(gen)
    assert all(avg[n].data_ptr() != p.data_ptr() for n, p in gen.named_parameters())
    with torch.no_grad():
        for p in gen.parameters():
            p.add_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    ref_avg = torch_to_jax_generator({n: v.clone() for n, v in avg.items()})[0]
    ref_params = torch_to_jax_generator(dict(gen.named_parameters()))[0]
    ref = jax_ema.make_ema_update(0.999)(jax.tree_util.tree_map(jnp.asarray, ref_avg),
                                         jax.tree_util.tree_map(jnp.asarray, ref_params))
    ema.make_ema_update(0.999)(avg, gen)
    want = jax_to_torch_generator(jax.tree_util.tree_map(np.asarray, ref))
    for n, v in avg.items():
        err = float((v - want[n]).abs().max())
        assert err <= 1e-6 * max(1.0, float(want[n].abs().max())), n
    live = dict(gen.named_parameters())
    assert not any(torch.equal(v, live[n]) for n, v in avg.items() if v.numel() > 1)


def test_with_ema_params_leaves_the_live_generator():
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    avg = {n: torch.full_like(p, 0.25) for n, p in gen.named_parameters()}
    before = {n: p.detach().clone() for n, p in gen.named_parameters()}
    copy = ema.with_ema_params(gen, avg)
    assert all(torch.equal(p, before[n]) for n, p in gen.named_parameters())
    assert all(float((p - 0.25).abs().max()) == 0 for p in copy.parameters())
    assert all(torch.equal(a, b) for a, b in zip(copy.buffers(), gen.buffers()))
