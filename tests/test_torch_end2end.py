"""The port's train step with end2end, end2end_d_only, gen_steps 2 (with and
without mean_gen_loss) and SGD against txt2vid_tpu's `build_train_step`, on
the CPU, over two steps from one state and one set of draws, in two
configurations: "end2end" (the encoder in both optimizers, gen_steps 2 with
mean_gen_loss, the gradient penalty 0.5, Adam) and "end2end_d_only_sgd" (the
encoder in D's optimizer alone, gen_steps 2 without mean_gen_loss, SGD with
momentum 0.5). Each JAX configuration costs one compile of its step, most of
this file's time.

The models, batch and variables are test_torch_train_step's (a tiny
conditional TGANv2 with Attention(32) in the generator and Attention3d(128)
in the discriminator, a one-layer Bi-LSTM encoder, kernels at half scale).
The JAX step runs its Pallas attention in interpret mode (K1-K3), jitted once
per configuration; its state starts from the encoder's full init (the
decoder's to_vocab included, as the JAX CLI's train state holds it), with
the encoder's moments in both optimizers under end2end and in D's under
end2end_d_only. Each of the port's two steps starts from a file the JAX
package wrote of the JAX state before it (the checkpoint path of these
optimizer trees), with JAX's draws: z and the derangement rebuilt from the
step's key splits (test_torch_gp_step.jax_z, jax_d_draws), the temporal
phases recorded by wrapping subsample_video, the generator's once per
forward: the D phase's fakes, then each G sub-step's.

"end2end"'s gradient penalty reaches the encoder through the interpolated
cond.

Adam starts from a resumed state (count 1, first moments 0, second moments
1e-4): from init, Adam's first update is lr * sign(g), and where a gradient
is float noise (a null leaf, such as a conv bias before a BatchNorm) the two
sides take opposite signs; a later update in the same step (G's second
sub-step, the G phase reading the encoder the D phase moved) then reads
parameters 2 * lr apart there. From a resumed state each update is a smooth
function of its gradient, and each side's parameters can be held to 1e-6.

Tolerances, test_torch_train_step's: losses 1e-5 relative, D's grad norm
1e-4 relative; D's Adam first moments (SGD's traces), the encoder's among
them, 1e-4 of the leaf scale (its max|value| floored at 1e-2 of its
optimizer's largest leaf; null leaves, below 1e-5 of the largest on both
sides, hold float noise there); G's BatchNorm running statistics 1e-5 of
max(1, max|value|); parameters, the encoder's included, within 1e-6.

G's gradients are held otherwise. In both configurations the G phase reads
an encoder the D phase moved, so its cond differs between the two sides by
float32 rounding, and the generator's first BatchNorm (base.up0.bn1, over
the ConvLSTM's 1x1 output, whose variance across the batch's frames is of
the order of its eps, 1e-5) turns such differences into large ones in G's
gradients: perturbing this cond by 6e-7 moves them by 1.8e-3 of their
largest. Where the cond is bit for bit the D phase's (test_torch_train_step,
test_torch_gp_step) the two sides agree at 1e-4. So G's first moments and grad norm are held, on both sides, to the
port's step in float64 from the same file and draws: within G_F64_TOL (1e-2)
of the leaf scale (measured: the port up to 5.0e-3, JAX up to 4.6e-3, both
at the BatchNorm biases of the generator's base), and the norm within 1e-2
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_gp_step import jax_d_draws, jax_z
from test_torch_models import jax_variables, pallas_interpret
from test_torch_train_step import (DISC, ENC, FRAME_SIZES, GEN, LR, _leaf_scales, host,
                                   jax_state, make_batch)
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.ops import subsample as jax_subsample
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch.convert import (jax_state_to_torch, jax_to_torch_discriminator,
                                       jax_to_torch_encoder, jax_to_torch_generator,
                                       torch_state_to_jax)
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import (Draws, TrainConfig, adam, build_train_step,
                                              optimizer_params, sgd)
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops import attention as port_attention
from txt2vid_tpu_torch.utils.checkpoint import restore_state

STEPS = 2
BATCH_SEED = 0
# G's gradients against the float64 step, either float32 side (see the
# module docstring)
G_F64_TOL = 1e-2
CONFIGS = {
    "end2end": dict(end2end=True, gen_steps=2, mean_gen_loss=True, gp_lambda=0.5),
    "end2end_d_only_sgd": dict(end2end=True, end2end_txt_in_g=False, gen_steps=2),
}
SGD = {"end2end_d_only_sgd"}


def config(name):
    return dict(frame_sizes=FRAME_SIZES, subsample_input=True, latent_size=GEN["latent_size"],
                shared_gen_fwd=True, **CONFIGS[name])


def jax_opt(name):
    return optax.sgd(LR, momentum=0.5) if name in SGD else optax.adam(LR, b1=0.5, b2=0.999)


def resumed(opt_state):
    """An Adam state as after one step: count 1, mu 0, nu 1e-4."""
    adam, rest = opt_state
    return (adam._replace(count=jnp.ones((), jnp.int32),
                          nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-4),
                                                    adam.nu)), rest)


def initial_state(name):
    """test_torch_train_step's state with the encoder's full init and, under
    end2end, the encoder in the optimizers' trees."""
    video, caps, lens = make_batch(BATCH_SEED)
    gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=True)
    disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=True)
    enc = JaxSeq2Seq(**ENC)
    opt = jax_opt(name)
    state = jax_state(gen, disc, enc, caps, lens, opt, opt)
    txt_vars = jax_variables(enc, 3, jnp.asarray(caps), jnp.asarray(lens))
    cfg = CONFIGS[name]
    g_tree = {"g": state.g_vars["params"]}
    d_tree = {"d": (state.d_vars[0]["params"],)}
    if cfg.get("end2end"):
        d_tree["txt"] = txt_vars["params"]
        if cfg.get("end2end_txt_in_g", True):
            g_tree["txt"] = txt_vars["params"]
    opt_g, opt_d = opt.init(g_tree), opt.init(d_tree)
    if name not in SGD:
        opt_g, opt_d = resumed(opt_g), resumed(opt_d)
    return state.replace(txt_vars=txt_vars, opt_g_state=opt_g, opt_d_state=opt_d)


def run_jax(name, state):
    """STEPS JAX steps from `state`: per step (state after, metrics, the
    recorded pyramid and generator phases)."""
    mp = pytest.MonkeyPatch()
    rec = {"pyramid": [], "gen": []}

    def recording(key, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            rec[key].append(out[1])
            return out
        return wrapped

    mp.setattr(jax_subsample, "subsample_video",
               recording("pyramid", jax_subsample.subsample_video))
    mp.setattr(jax_tganv2, "subsample_video", recording("gen", jax_tganv2.subsample_video))
    try:
        gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=True)
        disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=True)
        gan = JaxCondGan(gen=gen, discrims=[disc], cond_encoder=JaxSeq2Seq(**ENC))
        opt = jax_opt(name)
        step = jax_build_train_step(gan, jax_losses.RSGANLoss(), opt, opt,
                                    JaxTrainConfig(**config(name)))

        def run(state, batch, key):
            for v in rec.values():
                v.clear()
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        video, caps, lens = make_batch(BATCH_SEED)
        batch = {"video": jnp.asarray(video), "captions": jnp.asarray(caps),
                 "lengths": jnp.asarray(lens)}
        jitted = jax.jit(run)
        out = []
        with pallas_interpret():
            for _ in range(STEPS):
                state, metrics, draws = jitted(state, batch, jax.random.key(5))
                out.append((host(state), host(metrics), host(draws)))
    finally:
        mp.undo()
    return out


def port_step_from_file(name, path):
    """A port TrainStep whose models and optimizers are read from a JAX file."""
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    disc = tganv2.MultiScaleDiscrim(**DISC)
    gan = CondGan(gen, Seq2Seq(**ENC), discrims=[disc])
    cfg = TrainConfig(**config(name))
    g_params, d_params = optimizer_params(gan, cfg)
    make = (lambda p: sgd(p, LR, 0.5)) if name in SGD else (lambda p: adam(p, LR))
    step = build_train_step(gan, port_losses.RSGANLoss(), make(g_params), make(d_params),
                            cfg)
    jax_state_to_torch(restore_state(torch_state_to_jax(step), path), step)
    return step


def port_draws(name, i, draws):
    """Draws of step i: JAX's z and derangement (and GP weights), the
    recorded pyramid phases, and the generator's per forward."""
    n = len(FRAME_SIZES) - 1
    gen = [int(v) for v in draws["gen"]]
    subs = [gen[n * (j + 1):n * (j + 2)] for j in range(len(gen) // n - 1)]
    if subs:
        assert len(subs) == CONFIGS[name].get("gen_steps", 1) and subs[0] == gen[:n], \
            "one forward for the D phase's fakes, one per G sub-step, the first on its phases"
    perm, alphas = jax_d_draws(i, 0)
    return Draws(torch.from_numpy(jax_z(i)), [int(v) for v in draws["pyramid"][:n]],
                 gen[:n], [torch.from_numpy(perm).long()],
                 [[torch.from_numpy(a) for a in alphas]] if CONFIGS[name].get("gp_lambda")
                 else None, later_gen_phases=subs[1:])


def counting(mp):
    """Count the attention forwards and backwards (K1 and K2/K3 calls) on
    the CPU, where the launch counters stay at 0."""
    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = port_attention.fused_attention, port_attention.fused_attention_bwd

    def f(*a, **k):
        counts["fwd"] += 1
        return fwd(*a, **k)

    def b(*a, **k):
        counts["bwd"] += 1
        return bwd(*a, **k)

    mp.setattr(port_attention, "fused_attention", f)
    mp.setattr(port_attention, "fused_attention_bwd", b)
    return counts


def _attention64(theta, phi, g, use_kernel=True):
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def float64_step(name, path, i, draws):
    """The port's step in float64 (a float64 softmax; the losses stay
    float32, as on both sides) from the file at `path` with JAX's draws."""
    from txt2vid_tpu_torch.models import layers as port_layers
    video, caps, lens = make_batch(BATCH_SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_layers, "attention_core_auto", _attention64)
        step = port_step_from_file(name, path)
        for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
            m.double()
        for opt in (step.opt_g, step.opt_d):
            for st in opt.state.values():
                st.update({k: v.double() for k, v in st.items() if k != "step"})
        d = port_draws(name, i, draws)
        d.z = d.z.double()
        if d.alphas is not None:
            d.alphas = [[a.double() for a in per] for per in d.alphas]
        metrics = step({"video": torch.from_numpy(video).double(),
                        "captions": torch.from_numpy(caps).long(),
                        "lengths": torch.from_numpy(lens)}, d)
    step.metrics = {k: float(v) for k, v in metrics.items()}
    return step


def run_case(tmp, name):
    before = host(initial_state(name))
    out = []
    video, caps, lens = make_batch(BATCH_SEED)
    for i, (new, metrics, draws) in enumerate(run_jax(name, before)):
        path = tmp / f"{name}_{i}"
        jax_checkpoint.save_state(before, str(path))
        port = port_step_from_file(name, path)
        with pytest.MonkeyPatch.context() as mp:
            counts = counting(mp)
            pm = port({"video": torch.from_numpy(video),
                       "captions": torch.from_numpy(caps).long(),
                       "lengths": torch.from_numpy(lens)}, port_draws(name, i, draws))
        out.append(dict(before=before, new=new, metrics=metrics, port=port, counts=counts,
                        port_metrics={k: float(v) for k, v in pm.items()},
                        f64=float64_step(name, path, i, draws)))
        before = new
    return out


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request, tmp_path_factory):
    name = request.param
    return name, run_case(tmp_path_factory.mktemp(name), name)


def _opt_leaves(name, tree, side):
    """name -> the first moment (Adam's mu, SGD's trace) of one side's
    parameters in a JAX optimizer state, as port tensors."""
    st = tree.opt_g_state if side == "G" else tree.opt_d_state
    moment = st[0].trace if name in SGD else st[0].mu
    out = (jax_to_torch_generator(moment["g"]) if side == "G"
           else jax_to_torch_discriminator(moment["d"][0]))
    if "txt" in moment:
        out.update({f"txt.{k}": v for k, v in jax_to_torch_encoder(moment["txt"]).items()
                    if ".bias_ih_" not in k})
    return out


def _port_leaves(name, step, side):
    opt = step.opt_g if side == "G" else step.opt_d
    module = step.gan.gen if side == "G" else step.gan.discrims[0]
    key = "momentum_buffer" if name in SGD else "exp_avg"
    out = {n: opt.state[p][key] for n, p in module.named_parameters()}
    params = {id(p) for g in opt.param_groups for p in g["params"]}
    out.update({f"txt.{n}": opt.state[p][key]
                for n, p in step.gan.cond_encoder.named_parameters() if id(p) in params})
    return out


def _port_params(step, side):
    module = step.gan.gen if side == "G" else step.gan.discrims[0]
    out = {n: p.detach() for n, p in module.named_parameters()}
    out.update({f"txt.{n}": p.detach() for n, p in step.gan.cond_encoder.named_parameters()
                if p.requires_grad})
    return out


def _jax_params(tree, side):
    out = (jax_to_torch_generator(tree.g_vars["params"]) if side == "G"
           else jax_to_torch_discriminator(tree.d_vars[0]["params"]))
    out.update({f"txt.{k}": v for k, v in jax_to_torch_encoder(tree.txt_vars["params"]).items()
                if ".bias_ih_" not in k})
    return out


def test_losses_and_norms(case):
    """Losses and D's norm against JAX's; G's norm, both sides against the
    float64 step's (G_F64_TOL)."""
    _, steps = case
    for r in steps:
        for k, tol in (("loss_d", 1e-5), ("loss_g", 1e-5), ("grad_norm_d", 1e-4)):
            ref, got = float(r["metrics"][k]), r["port_metrics"][k]
            assert np.isfinite(got) and abs(got - ref) <= tol * abs(ref), (k, ref, got)
        ref = r["f64"].metrics["grad_norm_g"]
        for got in (float(r["metrics"]["grad_norm_g"]), r["port_metrics"]["grad_norm_g"]):
            assert abs(got - ref) <= G_F64_TOL * abs(ref), ("grad_norm_g", ref, got)


def _check_moments(ref, got, tol, what):
    assert set(ref) == set(got)
    scales, null, bound = _leaf_scales(ref)
    for n, want in ref.items():
        g = got[n].double()
        if n in null:
            assert float(g.abs().max()) < bound, f"{what} {n} is not null"
            continue
        err = float((want.double() - g).abs().max())
        assert err <= tol * scales[n], f"{what} {n}: {err} > {tol} * {scales[n]}"


@pytest.mark.parametrize("side", ["G", "D"])
def test_first_moments(case, side):
    """Adam's first moments, or SGD's traces, of G's or D's parameters and,
    where that optimizer holds it, the encoder's: D's against JAX's, G's
    (both sides) against the float64 step's."""
    name, steps = case
    for i, r in enumerate(steps):
        jax_side, port = _opt_leaves(name, r["new"], side), _port_leaves(name, r["port"], side)
        e2e = CONFIGS[name].get("end2end")
        in_g = e2e and CONFIGS[name].get("end2end_txt_in_g", True)
        assert any(k.startswith("txt.") for k in port) == bool(e2e if side == "D" else in_g)
        if side == "D":
            _check_moments(jax_side, port, 1e-4, f"step {i} D")
            continue
        f64 = _port_leaves(name, r["f64"], side)
        _check_moments(f64, port, G_F64_TOL, f"step {i} G port")
        _check_moments(f64, jax_side, G_F64_TOL, f"step {i} G jax")


@pytest.mark.parametrize("side", ["G", "D"])
def test_params_after_each_step(case, side):
    """G's and D's parameters and the encoder's (after both phases moved it)
    within 1e-6 of JAX's; each but the null leaves has moved."""
    name, steps = case
    for i, r in enumerate(steps):
        ref, got = _jax_params(r["new"], side), _port_params(r["port"], side)
        before = _jax_params(r["before"], side)
        _, null, _ = _leaf_scales(_opt_leaves(name, r["new"], side))
        for n, want in ref.items():
            assert float((want - got[n]).abs().max()) <= 1e-6, (i, side, n)
            if n not in null and not n.startswith("txt.encoder.to_vocab"):
                assert not torch.equal(want, before[n]), f"step {i}: {side} {n} did not move"


def test_encoder_in_the_optimizers(case):
    """The encoder's parameters, all but the LSTMs' frozen bias_ih, in D's
    optimizer and, under end2end, G's; its decoder projection, which no loss
    reads, has zero moments."""
    name, steps = case
    port = steps[-1]["port"]
    in_g = CONFIGS[name].get("end2end_txt_in_g", True)
    trained = [p for n, p in port.gan.cond_encoder.named_parameters() if ".bias_ih_" not in n]
    for opt, want in ((port.opt_d, True), (port.opt_g, in_g)):
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        assert all((id(p) in held) == want for p in trained)
    assert not any(p.requires_grad for n, p in port.gan.cond_encoder.named_parameters()
                   if ".bias_ih_" in n)
    d = _port_leaves(name, port, "D")
    assert float(d["txt.encoder.to_vocab.weight"].abs().max()) == 0.0


def test_generator_batch_norm_statistics(case):
    """G's running statistics after each step: one momentum update from the
    step's statistics whatever gen_steps is, as JAX's step keeps the last
    sub-step's update of state.g_vars."""
    _, steps = case
    for i, r in enumerate(steps):
        ref = jax_to_torch_generator(r["new"].g_vars["params"], r["new"].g_vars["batch_stats"])
        before = jax_to_torch_generator(r["before"].g_vars["params"],
                                        r["before"].g_vars["batch_stats"])
        port = r["port"].gan.gen.state_dict()
        names = [k for k in ref if k.endswith(("running_mean", "running_var"))]
        assert names
        for k in names:
            assert not torch.equal(before[k], ref[k]), f"{k} did not move"
            scale = max(1.0, float(ref[k].abs().max()))
            assert float((ref[k] - port[k]).abs().max()) <= 1e-5 * scale, (i, k)


def test_one_statistics_update_with_gen_steps_2():
    """The hazard: with gen_steps 2 each sub-step's statistics start from the
    step's. Re-running the last sub-step's forward from the step's
    statistics (the generator's parameters as the step left them, less the
    last update) gives the statistics the step kept; a second update on top
    of the first would not."""
    from txt2vid_tpu_torch.ops.initializers import init_from_seed
    torch.manual_seed(0)
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), 1)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), 2)
    enc = init_from_seed(Seq2Seq(**ENC), 3)
    gan = CondGan(gen, enc, discrims=[disc])
    cfg = TrainConfig(**{**config("end2end_d_only_sgd"), "end2end": False})
    step = build_train_step(gan, port_losses.RSGANLoss(), adam(gen.parameters()),
                            adam(disc.parameters()), cfg, seed=4)
    video, caps, lens = make_batch(1)
    batch = {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
             "lengths": torch.from_numpy(lens)}
    start = {n: b.clone() for n, b in gen.named_buffers()}
    sub_params = []
    orig = step._gen_loss

    def record(fakes, real_preds, cond_scales):
        sub_params.append({n: p.detach().clone() for n, p in gen.named_parameters()})
        return orig(fakes, real_preds, cond_scales)

    step._gen_loss = record
    draws = step.draw(video.shape[0], "cpu")
    step(batch, draws)
    kept = {n: b.clone() for n, b in gen.named_buffers()}
    with torch.no_grad():
        for n, b in gen.named_buffers():
            b.copy_(start[n])
        for n, p in gen.named_parameters():
            p.copy_(sub_params[-1][n])
        cond = enc.encode(batch["captions"], batch["lengths"])[2]
        gan.generate(draws.z, cond=cond, train=True, phases=draws.gen_step(1))
    names = [n for n in kept if n.endswith(("running_mean", "running_var"))]
    assert len(sub_params) == 2 and names
    for n in names:
        assert not torch.equal(kept[n], start[n]), n
        torch.testing.assert_close(kept[n], dict(gen.named_buffers())[n], rtol=0, atol=1e-6)


def attention_calls(name, scales=len(FRAME_SIZES)):
    """The attention forwards (K1) and backwards (K2 and K3) of one step,
    counted from the code as chip_smoke.train_launches counts them, with
    one generator attention and the discriminator's at `scales` scales. The
    two-forward form: the D phase's fakes (1), the D phase's real_cc and
    fake_cc (2 * scales, backward too), the updated D's real predictions
    (scales, no gradient), then per G sub-step the generator and the fake
    pass (1 + scales, backward too); under end2end the real predictions move
    into each sub-step (forward only: no gradient reaches the attention from
    the encoder). The shared form (gen_steps 1 outside end2end): one
    generator forward, 4 * scales forwards and 1 + 3 * scales backwards."""
    cfg = CONFIGS[name]
    g = cfg.get("gen_steps", 1)
    if not cfg.get("end2end") and g == 1:
        return {"fwd": 1 + 4 * scales, "bwd": 1 + 3 * scales}
    if cfg.get("end2end") and cfg.get("end2end_txt_in_g", True):
        return {"fwd": 1 + 2 * scales + g * (1 + 2 * scales), "bwd": 2 * scales + g * (1 + scales)}
    return {"fwd": 1 + 3 * scales + g * (1 + scales), "bwd": 2 * scales + g * (1 + scales)}


def test_attention_calls_per_step(case):
    """attention_calls at this configuration: end2end 21 forwards and 14
    backwards, end2end_d_only 18 and 14."""
    name, steps = case
    for r in steps:
        assert r["counts"] == attention_calls(name), (name, r["counts"])


def test_checkpoint_round_trip_is_byte_for_byte(case, tmp_path):
    """The port's state after its step, written by the port and read back
    into a fresh step, writes the same bytes; JAX restores the file into its
    own state's structure (the SGD trace, the "txt" subtrees)."""
    from txt2vid_tpu_torch.utils.checkpoint import save_state
    name, steps = case
    r = steps[-1]
    save_state(torch_state_to_jax(r["port"]), tmp_path / "a")
    fresh = port_step_from_file(name, tmp_path / "a")
    save_state(torch_state_to_jax(fresh), tmp_path / "b")
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    back = host(jax_checkpoint.restore_state(r["new"], str(tmp_path / "a")))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(r["new"])
