"""The port's train step with the gradient penalty, its quarantine, in-step
clipping and discrim_steps 2 against txt2vid_tpu's `build_train_step`, on
the CPU, from one state and one set of draws.

The models, batch, optimizers and variables are test_torch_train_step's (a
tiny conditional TGANv2, Adam(2e-4, 0.5, 0.999), kernels at half scale). The
JAX attention runs its plain reference (use_pallas=False): the Pallas kernels'
interpret mode is held to it elsewhere, and the GP runs under no_pallas() in
any case. The JAX step is jitted once per configuration.

This file runs "gp": gp_lambda 0.5 every step, gp_quarantine, clip_grad 1e-3
(below every norm here, so both phases clip) and discrim_steps 2;
test_torch_gp_lazy.py runs "lazy" with the helpers here. The port's state is read from a file the JAX package wrote with its
save_state (the checkpoint interop path), and its draws are JAX's: z from the
step's key split, the temporal phases recorded by wrapping subsample_video,
and each D step's derangement and GP interpolation weights rebuilt from the
key splits of all_discrim_forward and multiscale_gradient_penalty; in the
"gp" run these are checked against the values recorded by wrapping
gen_perm_device and the GP's _interpolate.

Tolerances: losses 1e-5 relative, grad norms 1e-4 relative, gp_quarantined
equal. Through the penalty's double backward the JAX step's own float32
Adam moments stray further from a float64 run of the same step than the
port's do, so, as test_torch_train_step's float64 test does, both sides are
held to the port's step in float64 from the same file and draws: Adam's
first moment and the square root of its second within 1e-4 (port; measured
up to 5.3e-5) and 5e-4 (JAX; measured up to 2.2e-4) of the leaf scale (its
max|value|, floored at 1e-2 of the phase's largest; null leaves hold noise
below 1e-5 of it). A step from a trained state (the lazy run's step 1) is
held to 1e-3 and 2e-3 (measured 5.9e-4 and 1.3e-3). Parameters within 1e-6
of the float64 step on both sides (measured up to 6.1e-7), except where the
float64 first moment is below 3e-2 of the leaf scale: there the moments'
float noise is a large share of the element, Adam's normalised update can
take any direction, and 2 * lr per update is allowed.

Torch runs on one intra-op thread (beside other test processes its thread
pool oversubscribes the cores). With 1, 2 or 4 threads (of 8 cores) torch's
CPU BatchNorm backward sums in another order, and the port's G gradients sit
up to 8e-3 of their leaf scale from the float64 step (measured; with 3 or 8
threads within 4e-5), its G norm 1.7e-4 relative: the port's G moments are
held to the float64 step within test_torch_train_step's G_F64_TOL, its G
norm within G_F64_NORM_TOL, its G parameters within G_PARAM_TOL where not
sign-free (measured 8.3e-6: fc.weight's gradients, about 1e-7 to 3e-6, sit
near Adam's eps, where the update's size follows the gradient's); JAX's G
norm is held to the float64 step's at 1e-4 too. D's side and the losses are
as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import jax_variables
from test_torch_train_step import (B, DISC, ENC, FRAME_SIZES, G_F64_NORM_TOL, G_F64_TOL,
                                   G_PARAM_TOL, GEN, LR, _leaf_scales,
                                   _one_torch_thread, host, jax_state, make_batch)  # noqa: F401
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.ops import subsample as jax_subsample
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu.utils import misc as jax_misc
from txt2vid_tpu_torch.convert import (jax_state_to_torch, jax_to_torch_discriminator,
                                       jax_to_torch_generator, torch_state_to_jax)
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import Draws, TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import layers as port_layers
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.utils.checkpoint import restore_state


KEY = 5
CONFIGS = {
    "gp": dict(gp_lambda=0.5, gp_quarantine=True, clip_grad=1e-3, discrim_steps=2),
    "lazy": dict(gp_lambda=0.5, gp_every=2),
}


def common():
    return dict(frame_sizes=FRAME_SIZES, subsample_input=True, latent_size=GEN["latent_size"],
                shared_gen_fwd=True)


def jax_models():
    gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=False)
    disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False)
    enc = JaxSeq2Seq(**ENC)
    return gen, disc, enc


def jax_d_draws(step: int, j: int):
    """D step j's derangement and per-scale GP weights of the JAX step at
    counter `step`: the key splits of train_step (fold_in step, split 5,
    fold_in j), all_discrim_forward (perm key, then GP key) and
    multiscale_gradient_penalty (one key per scale)."""
    key = jax.random.fold_in(jax.random.key(KEY), step)
    k_d = jax.random.split(key, 5)[3]
    dkey, perm_key = jax.random.split(jax.random.fold_in(k_d, j))
    perm = jax_misc.gen_perm_device(perm_key, B)
    _, gp_key = jax.random.split(dkey)
    keys = jax.random.split(gp_key, len(FRAME_SIZES))
    alphas = [jax.random.uniform(keys[s], (B >> s, 1, 1, 1, 1)).reshape(-1)
              for s in range(len(FRAME_SIZES))]
    return np.asarray(perm), [np.asarray(a) for a in alphas]


def jax_z(step: int):
    k_z = jax.random.split(jax.random.fold_in(jax.random.key(KEY), step), 5)[0]
    return np.array(jax.random.normal(k_z, (B, GEN["latent_size"])))


def run_jax(cfg, state, steps, record_d_draws):
    """`steps` JAX steps from `state`; per step (state after, metrics, the
    recorded phases and, with record_d_draws, derangements and weights)."""
    mp = pytest.MonkeyPatch()
    rec = {"pyramid": [], "gen": [], "perm": [], "alpha": []}

    def recording(name, fn, pick, when=lambda *a, **k: True):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if when(*args, **kwargs):
                rec[name].append(pick(out, *args))
            return out
        return wrapped

    mp.setattr(jax_subsample, "subsample_video",
               recording("pyramid", jax_subsample.subsample_video, lambda o, *a: o[1]))
    mp.setattr(jax_tganv2, "subsample_video",
               recording("gen", jax_tganv2.subsample_video, lambda o, *a: o[1]))
    if record_d_draws:
        mp.setattr(jax_misc, "gen_perm_device",
                   recording("perm", jax_misc.gen_perm_device, lambda o, *a: o))
        mp.setattr(jax_losses, "_interpolate",
                   recording("alpha", jax_losses._interpolate,
                             lambda o, alpha, *a: alpha.reshape(-1),
                             when=lambda alpha, real, fake: real.ndim == 5))
    try:
        gen, disc, enc = jax_models()
        gan = JaxCondGan(gen=gen, discrims=[disc], cond_encoder=enc)
        opt = optax.adam(LR, b1=0.5, b2=0.999)
        step = jax_build_train_step(gan, jax_losses.RSGANLoss(), opt, opt,
                                    JaxTrainConfig(**common(), **cfg))

        def run(state, batch, key):
            for v in rec.values():
                v.clear()
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        video, caps, lens = make_batch()
        batch = {"video": jnp.asarray(video), "captions": jnp.asarray(caps),
                 "lengths": jnp.asarray(lens)}
        jitted = jax.jit(run)
        out = []
        for _ in range(steps):
            state, metrics, draws = jitted(state, batch, jax.random.key(KEY))
            out.append((host(state), host(metrics), host(draws)))
    finally:
        mp.undo()
    return out


def port_from_file(path, cfg, template_state):
    """A port TrainStep whose models and optimizers are read from a JAX checkpoint."""
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    disc = tganv2.MultiScaleDiscrim(**DISC)
    enc = Seq2Seq(**ENC)
    step = build_train_step(CondGan(gen, enc, discrims=[disc]), port_losses.RSGANLoss(),
                            adam(gen.parameters()), adam(disc.parameters()),
                            TrainConfig(**common(), **cfg))
    jax_state_to_torch(restore_state(torch_state_to_jax(step), path), step)
    return step


def port_batch():
    video, caps, lens = make_batch()
    return {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
            "lengths": torch.from_numpy(lens)}


def port_draws(step_idx, draws, discrim_steps=1, dtype=torch.float32):
    d_steps = []
    for j in range(discrim_steps):
        perm, alphas = jax_d_draws(step_idx, j)
        d_steps.append(([torch.from_numpy(perm).long()],
                         [[torch.from_numpy(a).to(dtype) for a in alphas]]))
    return Draws(torch.from_numpy(jax_z(step_idx)).to(dtype),
                 [int(v) for v in draws["pyramid"]], [int(v) for v in draws["gen"]],
                 *d_steps[0], later_d_steps=d_steps[1:])


def _attention64(theta, phi, g, use_kernel=True):
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def port_step(path, cfg, step_idx, draws, float64=False):
    """The port's step from the JAX file at `path` with JAX's draws; in
    float64 with a float64 softmax (the losses stay float32, as on both
    sides). Returns (TrainStep after the step, its metrics as floats)."""
    ds = cfg.get("discrim_steps", 1)
    dtype = torch.float64 if float64 else torch.float32
    with pytest.MonkeyPatch.context() as mp:
        if float64:
            mp.setattr(port_layers, "attention_core_auto", _attention64)
        step = port_from_file(path, cfg, None)
        if float64:
            for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
                m.double()
            for opt in (step.opt_g, step.opt_d):
                for st in opt.state.values():
                    st.update({k: v.double() for k, v in st.items() if k != "step"})
        batch = port_batch()
        batch["video"] = batch["video"].to(dtype)
        metrics = step(batch, port_draws(step_idx, draws, ds, dtype))
    return step, {k: float(v) for k, v in metrics.items()}


def initial_state():
    video, caps, lens = make_batch()
    gen, disc, enc = jax_models()
    opt = optax.adam(LR, b1=0.5, b2=0.999)
    # the encoder's variables from Seq2Seq's own init, which (unlike
    # test_torch_train_step's encode-only init) holds the decoder's to_vocab,
    # as every train state of the JAX CLI does
    return jax_state(gen, disc, enc, caps, lens, opt, opt).replace(
        txt_vars=jax_variables(enc, 3, jnp.asarray(caps), jnp.asarray(lens)))


def run_case(tmp, name, steps, record_d_draws=False):
    """`steps` JAX steps of configuration `name` from initial_state(); per
    step a dict: the JAX state after it, its metrics and draws, and the
    port's step (float32 and float64) from a JAX file of the state before it."""
    cfg = CONFIGS[name]
    before = host(initial_state())
    out = []
    for i, (new, metrics, draws) in enumerate(
            run_jax(cfg, before, steps, record_d_draws)):
        path = tmp / f"{name}_{i}"
        jax_checkpoint.save_state(before, str(path))
        port, port_metrics = port_step(path, cfg, i, draws)
        assert port.step == i + 1
        f64, f64_metrics = port_step(path, cfg, i, draws, float64=True)
        out.append(dict(new=new, metrics=metrics, draws=draws, port=port,
                        port_metrics=port_metrics, f64=f64, f64_metrics=f64_metrics))
        before = new
    return out


def _module(step, side):
    return step.gan.gen if side == "G" else step.gan.discrims[0]


def _moments(step, side, which):
    """name -> the port's Adam first moment ("mu") or the square root of its
    second ("nu"), compared on the gradient's scale."""
    opt = step.opt_g if side == "G" else step.opt_d
    key = {"mu": "exp_avg", "nu": "exp_avg_sq"}[which]
    out = {n: opt.state[p][key].double() for n, p in _module(step, side).named_parameters()}
    return {n: v.sqrt() for n, v in out.items()} if which == "nu" else out


def _jax_moments(tree, side, which):
    if side == "G":
        out = jax_to_torch_generator(getattr(tree.opt_g_state[0], which)["g"])
    else:
        out = jax_to_torch_discriminator(getattr(tree.opt_d_state[0], which)["d"][0])
    return {n: v.double().sqrt() for n, v in out.items()} if which == "nu" else out


def check_losses_and_norms(r):
    """Losses and D's norm against JAX's; G's norm, both sides against the
    float64 step's (the port's within G_F64_NORM_TOL)."""
    for k, tol in (("loss_d", 1e-5), ("loss_g", 1e-5), ("grad_norm_d", 1e-4)):
        ref, got = float(r["metrics"][k]), r["port_metrics"][k]
        assert np.isfinite(got) and got > 0 and abs(got - ref) <= tol * abs(ref), (k, ref, got)
    ref = r["f64_metrics"]["grad_norm_g"]
    for who, got, tol in (("port", r["port_metrics"]["grad_norm_g"], G_F64_NORM_TOL),
                          ("jax", float(r["metrics"]["grad_norm_g"]), 1e-4)):
        print(f"grad_norm_g {who} vs float64: {abs(got - ref) / abs(ref):.3g} (tol {tol})")
        assert got > 0 and abs(got - ref) <= tol * abs(ref), (who, "grad_norm_g", ref, got)
    assert set(r["port_metrics"]) == set(r["metrics"])


def check_moments(r, side, which, tols=(1e-4, 5e-4)):
    """Both sides' moments against the float64 step's: tols = (port, JAX),
    of the floored leaf scale; the port's G within G_F64_TOL."""
    ref = _moments(r["f64"], side, which)
    scales, null, bound = _leaf_scales(ref)
    assert len(null) < len(ref) // 4
    sides = {"port": (_moments(r["port"], side, which), G_F64_TOL if side == "G" else tols[0]),
             "jax": (_jax_moments(r["new"], side, which), tols[1])}
    for who, (got, tol) in sides.items():
        assert set(got) == set(ref)
        worst = 0.0
        for n, want in ref.items():
            g = got[n].double()
            if n in null:
                assert float(g.abs().max()) < bound, f"{who} {side} {n} is not null"
                continue
            err = float((want - g).abs().max())
            worst = max(worst, err / scales[n])
            assert err <= tol * scales[n], f"{who} {side} {which} {n}: {err} > {tol} * {scales[n]}"
        print(f"{who} {side} {which} vs float64: {worst:.3g} of the leaf scale (tol {tol})")


def check_params(r, side, n_updates=1):
    ref = {n: p.detach() for n, p in _module(r["f64"], side).named_parameters()}
    grads = _moments(r["f64"], side, "mu")
    scales, null, _ = _leaf_scales(grads)
    jax_params = (jax_to_torch_generator(r["new"].g_vars["params"]) if side == "G"
                  else jax_to_torch_discriminator(r["new"].d_vars[0]["params"]))
    port_params = {n: p.detach() for n, p in _module(r["port"], side).named_parameters()}
    for who, got in (("port", port_params), ("jax", jax_params)):
        tol = G_PARAM_TOL if (who, side) == ("port", "G") else 1e-6
        worst = 0.0
        for n, want in ref.items():
            free = ((grads[n].abs() < 3e-2 * scales[n]) | (n in null)).numpy()
            diff = (want - got[n].double()).abs().numpy()
            worst = max(worst, float(diff[~free].max(initial=0.0)))
            assert float(diff[~free].max(initial=0.0)) <= tol, (who, n)
            assert float(diff[free].max(initial=0.0)) <= 2 * n_updates * LR + 1e-6, (who, n)
        print(f"{who} {side} parameters vs float64: {worst:.3g} where not sign-free (tol {tol})")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    (r,) = run_case(tmp_path_factory.mktemp("gp"), "gp", 1, record_d_draws=True)
    return r


def test_recorded_draws_are_the_rebuilt_ones(run):
    """The derangements and GP weights the JAX step drew (recorded through
    gen_perm_device and _interpolate) are the ones jax_d_draws rebuilds: per
    D step, the main pass's and the GP pass's derangement, then S weights."""
    draws = run["draws"]
    assert len(draws["perm"]) == 4 and len(draws["alpha"]) == 2 * len(FRAME_SIZES)
    for j in range(2):
        perm, alphas = jax_d_draws(0, j)
        np.testing.assert_array_equal(draws["perm"][2 * j], perm)
        np.testing.assert_array_equal(draws["perm"][2 * j + 1], perm)
        for s, a in enumerate(alphas):
            np.testing.assert_array_equal(draws["alpha"][j * len(FRAME_SIZES) + s], a)


def test_losses_and_norms(run):
    check_losses_and_norms(run)


def test_quarantine_metric(run):
    assert int(run["metrics"]["gp_quarantined"]) == int(run["port_metrics"]["gp_quarantined"]) == 0


def test_clip_engaged(run):
    """clip_grad 1e-3 sits far below both phases' norms, so both clipped."""
    assert run["metrics"]["grad_norm_d"] > 1e-2 and run["metrics"]["grad_norm_g"] > 1e-2


@pytest.mark.parametrize("side", ["G", "D"])
@pytest.mark.parametrize("which", ["mu", "nu"])
def test_adam_moments(run, side, which):
    check_moments(run, side, which)


@pytest.mark.parametrize("side", ["G", "D"])
def test_params_after_step(run, side):
    check_params(run, side, n_updates=2 if side == "D" else 1)


def test_step_counter_and_counts_written_back(run):
    """The port's state after the step, in the JAX format, carries the step
    counter and both Adam counts (D: two updates), as JAX's does."""
    tree = torch_state_to_jax(run["port"])
    assert int(tree["step"]) == int(run["new"].step) == 1
    assert int(tree["opt_g_state"]["0"]["count"]) == int(run["new"].opt_g_state[0].count) == 1
    assert int(tree["opt_d_state"]["0"]["count"]) == int(run["new"].opt_d_state[0].count) == 2


def test_quarantine_split_equals_the_fused_step(tmp_path):
    """main + gp_only (gp_quarantine) is the fused GP step: the same losses,
    norms, moments and parameters (float32, 1e-6 relative: only the order of
    the gradient sums differs)."""
    before = host(initial_state())
    path = tmp_path / "iter_0"
    jax_checkpoint.save_state(before, str(path))
    draws = {"pyramid": [0, 1], "gen": [1, 0]}
    cfgs = {"split": dict(gp_lambda=0.5, gp_quarantine=True),
            "fused": dict(gp_lambda=0.5)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(CONFIGS, "split", cfgs["split"])
        mp.setitem(CONFIGS, "fused", cfgs["fused"])
        (a, ma), (b, mb) = (port_step(path, cfgs[k], 0, draws) for k in ("split", "fused"))
    assert ma.pop("gp_quarantined") == 0
    for k in mb:
        assert abs(ma[k] - mb[k]) <= 1e-6 * abs(mb[k]), k
    for side in ("G", "D"):
        for which in ("mu", "nu"):
            fused, split = _moments(b, side, which), _moments(a, side, which)
            top = max(float(v.abs().max()) for v in fused.values())
            for n, v in fused.items():
                assert float((v - split[n]).abs().max()) <= 1e-5 * top, (side, which, n)
