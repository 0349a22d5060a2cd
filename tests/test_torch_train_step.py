"""One txt2vid_tpu_torch train step against one txt2vid_tpu `build_train_step`
step, on the CPU, from the same state, batch and random draws.

The configuration is a tiny conditional TGANv2: a generator with Attention(32)
in up0 (d = 4, dv = 16) rendering 8/16/32 px, a shared Resnet3D of two
DownBlocks with Attention3d(128) after down0 (d = 16, dv = 64), a one-layer
Bi-LSTM caption encoder (frozen, as outside end2end), RSGAN, Adam(2e-4, 0.5,
0.999) on both sides, the subsample pyramid and `shared_gen_fwd`. Every
variable is random (attention gammas nonzero: at 0 the attention gradients
vanish and K2/K3's formulas go untested).

The JAX step runs with its Pallas attention in interpret mode, compiled once
with jax.jit (op by op it is several times slower on one CPU core). Its random
draws (the pyramid's and the generator's temporal phases, the caption
derangement) are recorded by wrapping txt2vid_tpu.ops.subsample.subsample_video,
txt2vid_tpu.models.tganv2.subsample_video and
txt2vid_tpu.utils.misc.gen_perm_device with pytest's monkeypatch and returned
as outputs of the same program; z is rebuilt from the step's key split. The
port's step takes them as its `draws`.

Tolerances: losses 1e-5 relative, grad norms 1e-4 relative; Adam first moments
(0.5 * gradient after one step) 1e-4 * the leaf's scale; BatchNorm running
statistics 1e-5 * scale; parameters after the step within 1e-6, except where
|g_jax| < 1e-4 * the leaf's scale: there Adam's first update
lr * g / (|g| + eps) takes its sign from float noise, so 2 * lr is allowed.
A leaf's scale is its max|moment|, floored at 1e-2 * the largest of its phase:
below that, gradients are differences of far larger terms, and their float32
rounding against a float64 run of the same step is a large share of the leaf.
Some gradients are zero in exact arithmetic (a conv bias before a BatchNorm;
the last DownBlock's biases, which cancel in every RSGAN difference): such a
null leaf holds float noise below 1e-5 * the phase's largest on both sides,
which is what is checked there, and all its parameters count as sign-free.

The file runs torch on one intra-op thread (beside other test processes its
thread pool oversubscribes the cores). There torch's CPU BatchNorm backward
sums in another order, and the tiny generator's first BatchNorm, over the
ConvLSTM's 1x1 output, makes G's gradients ill-conditioned: the port's
float32 G gradients stray from a float64 run of the same step by up to
8.9e-3 of the leaf scale (measured, at fc.weight; test_torch_end2end.py
found the same), and G's norm by 1.4e-4. So G's gradients (its norm, Adam
first moments and parameters) are held to the port's step in float64 from
the same state and draws: the port's moments within G_F64_TOL and its norm
within G_F64_NORM_TOL, JAX's within its float32 tolerances above; losses,
D's norm and D's comparisons keep JAX as their reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import jax_variables, pallas_interpret
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import GanTrainState
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.ops import subsample as jax_subsample
from txt2vid_tpu.utils import misc as jax_misc
from txt2vid_tpu_torch.convert import (jax_to_torch_discriminator, jax_to_torch_generator,
                                       load_encoder_vars)
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import (Draws, TrainConfig, adam,
                                              build_train_step, check_config)
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.fused_attention import (attention_bwd_dkv, attention_bwd_dq,
                                                   fused_attention)

GEN = dict(latent_size=8, width=32, height=32, fm_channels=32, additional_blocks=(32, 16),
           num_frames=8, cond_dim=16)
DISC = dict(discrim_down_blocks=(2, 2, 2), cond_dim=16)
ENC = dict(vocab_size=20, embed_size=8, hidden_size=16, num_layers=1)
FRAME_SIZES = (8, 16, 32)
B, LR = 4, 2e-4
# Kernels at half the variance-preserving scale of test_torch_models'
# random_variables: at full scale the residual stacks grow the activations
# until the generator's attention softmax saturates, and the JAX step's own
# float32 gradients stray from a float64 run of the same step by far more than
# the tolerances below; at half scale test_both_sides_match_a_float64_step
# holds both sides to the float64 step.
KERNEL_SCALE = 0.5
# the port's float32 G side against the float64 step at one thread (module
# docstring): Adam first moments over the leaf scale, the norm relative, and
# the parameters after the step where not sign-free, a fifth of Adam's
# first update
G_F64_TOL, G_F64_NORM_TOL, G_PARAM_TOL = 2e-2, 1e-3, LR / 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (B, 8, 32, 32, 3)).astype(np.float32)
    caps = rng.integers(1, ENC["vocab_size"], (B, 6)).astype(np.int32)
    lens = np.array([6, 3, 5, 2], np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    return video, caps, lens


def scaled_kernels(tree, factor=KERNEL_SCALE):
    """Every conv and dense kernel of a variable tree times `factor`."""
    return {k: scaled_kernels(v, factor) if isinstance(v, dict)
            else (v * np.float32(factor) if k == "kernel" else v) for k, v in tree.items()}


def jax_state(gen, disc, enc, caps, lens, opt_g, opt_d):
    g_vars = jax_variables(gen, 1, jnp.zeros((B, GEN["latent_size"])),
                           jnp.zeros((B, GEN["cond_dim"])), train=True)
    scales = [jnp.zeros((B >> i, 8 >> i, fs, fs, 3)) for i, fs in enumerate(FRAME_SIZES)]
    conds = [jnp.zeros((B >> i, DISC["cond_dim"])) for i in range(len(FRAME_SIZES))]
    d_vars = jax_variables(disc, 2, scales, cond=conds, train=True)
    g_vars, d_vars = scaled_kernels(g_vars), scaled_kernels(d_vars)
    t_vars = jax_variables(enc, 3, jnp.asarray(caps), jnp.asarray(lens), method=enc.encode)
    return GanTrainState(
        step=jnp.zeros((), jnp.int32), g_vars=g_vars, d_vars=(d_vars,), txt_vars=t_vars,
        m_vars=None, opt_g_state=opt_g.init({"g": g_vars["params"]}),
        opt_d_state=opt_d.init({"d": (d_vars["params"],)}))


def port_models(state):
    gen = tganv2.MultiScaleGen(**GEN, with_non_local=True)
    gen.load_state_dict(jax_to_torch_generator(state.g_vars["params"],
                                               state.g_vars["batch_stats"]))
    disc = tganv2.MultiScaleDiscrim(**DISC)
    disc.load_state_dict(jax_to_torch_discriminator(state.d_vars[0]["params"]))
    enc = Seq2Seq(**ENC)
    with torch.no_grad():       # an encode-only tree: the decoder's to_vocab stays
        load_encoder_vars(enc, state.txt_vars)
    return gen, disc, enc


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def steps():
    return run_both_steps()


def run_both_steps():
    """Both sides' state before and after one step, and their metrics."""
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
    try:
        gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=True)
        disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=True)
        enc = JaxSeq2Seq(**ENC)
        gan = JaxCondGan(gen=gen, discrims=[disc], cond_encoder=enc)
        cfg = JaxTrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                             latent_size=GEN["latent_size"], shared_gen_fwd=True)
        opt_g = optax.adam(LR, b1=0.5, b2=0.999)
        opt_d = optax.adam(LR, b1=0.5, b2=0.999)
        video, caps, lens = make_batch()
        state = jax_state(gen, disc, enc, caps, lens, opt_g, opt_d)
        step = jax_build_train_step(gan, jax_losses.RSGANLoss(), opt_g, opt_d, cfg)

        def run(state, batch, key):
            for v in rec.values():
                v.clear()
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        key = jax.random.key(5)
        with pallas_interpret():
            new, metrics, draws = jax.jit(run)(
                state, {"video": jnp.asarray(video), "captions": jnp.asarray(caps),
                        "lengths": jnp.asarray(lens)}, key)
    finally:
        mp.undo()
    k_z = jax.random.split(jax.random.fold_in(key, 0), 5)[0]
    z = np.array(jax.random.normal(k_z, (B, GEN["latent_size"])))
    assert len(draws["pyramid"]) == 2 and len(draws["gen"]) == 2 and len(draws["perm"]) == 1

    port_gen, port_disc, port_enc = port_models(state)
    port_gan = CondGan(port_gen, port_enc, discrims=[port_disc])
    opts = adam(port_gen.parameters()), adam(port_disc.parameters())
    port_step = build_train_step(port_gan, port_losses.RSGANLoss(), *opts,
                                 TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                             latent_size=GEN["latent_size"],
                                             shared_gen_fwd=True))
    counts = [f.launches for f in (fused_attention, attention_bwd_dq, attention_bwd_dkv)]
    port_metrics = port_step(
        {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
         "lengths": torch.from_numpy(lens)},
        Draws(torch.from_numpy(z), [int(v) for v in draws["pyramid"]],
              [int(v) for v in draws["gen"]],
              [torch.from_numpy(np.array(draws["perm"][0])).long()]))
    counts = [f.launches - c for f, c in zip((fused_attention, attention_bwd_dq,
                                              attention_bwd_dkv), counts)]
    return dict(old=host(state), new=host(new), metrics=host(metrics),
                port_metrics={k: float(v) for k, v in port_metrics.items()},
                gen=port_gen, disc=port_disc, opts=opts, counts=counts,
                draws=dict(z=z, pyramid=[int(v) for v in draws["pyramid"]],
                           gen=[int(v) for v in draws["gen"]], perm=draws["perm"][0]))


def _moments(opt, module, convert, tree):
    """(name -> port exp_avg, name -> JAX mu) for the module's parameters."""
    port = {name: opt.state[p]["exp_avg"] for name, p in module.named_parameters()}
    return port, convert(tree)


def _leaf_scales(ref):
    """(name -> the leaf's max|value| floored at 1e-2 * the largest leaf's,
    the null leaves' names, the null bound 1e-5 * the largest)."""
    top = max(float(v.abs().max()) for v in ref.values())
    null = {k for k, v in ref.items() if float(v.abs().max()) < 1e-5 * top}
    return ({k: max(float(v.abs().max()), 1e-2 * top) for k, v in ref.items()},
            null, 1e-5 * top)


def test_losses(steps):
    for k in ("loss_d", "loss_g"):
        ref, got = float(steps["metrics"][k]), steps["port_metrics"][k]
        assert np.isfinite(got) and abs(got - ref) <= 1e-5 * abs(ref), (k, ref, got)


def test_grad_norms(steps, float64_step):
    """D's norm against JAX's; G's norm, both sides against the float64
    step's (the port's within G_F64_NORM_TOL)."""
    ref, got = float(steps["metrics"]["grad_norm_d"]), steps["port_metrics"]["grad_norm_d"]
    assert got > 0 and abs(got - ref) <= 1e-4 * abs(ref), ("grad_norm_d", ref, got)
    ref = float64_step["metrics"]["grad_norm_g"]
    for who, got, tol in (("port", steps["port_metrics"]["grad_norm_g"], G_F64_NORM_TOL),
                          ("jax", float(steps["metrics"]["grad_norm_g"]), 1e-4)):
        print(f"grad_norm_g {who} vs float64: {abs(got - ref) / abs(ref):.3g} (tol {tol})")
        assert got > 0 and abs(got - ref) <= tol * abs(ref), (who, "grad_norm_g", ref, got)


def _all_moments(steps):
    new = steps["new"]
    opt_g, opt_d = steps["opts"]
    g = _moments(opt_g, steps["gen"], lambda t: jax_to_torch_generator(t),
                 new.opt_g_state[0].mu["g"])
    d = _moments(opt_d, steps["disc"], jax_to_torch_discriminator,
                 new.opt_d_state[0].mu["d"][0])
    return {"G": g, "D": d}


def worst_leaf(ref, got, who):
    """{(who, name): max|diff| / the leaf's scale} over the non-null leaves
    of `ref`; a null leaf of `got` must hold noise below the null bound."""
    scales, null, bound = _leaf_scales(ref)
    worst = {}
    for name, r in ref.items():
        g = got[name].double()
        if name in null:
            assert float(g.abs().max()) < bound, f"{who} {name} is not null"
            continue
        worst[who, name] = float((r.double() - g).abs().max()) / scales[name]
    return worst


@pytest.mark.parametrize("side", ["G", "D"])
def test_adam_first_moments(steps, float64_step, side):
    """D's Adam first moments within 1e-4 of the leaf scale of JAX's; G's
    within G_F64_TOL of the float64 step's (the module docstring)."""
    port, ref = _all_moments(steps)[side]
    tol = 1e-4
    if side == "G":
        ref, tol = float64_step["moments"]["G"], G_F64_TOL
    assert set(port) == set(ref)
    assert len(_leaf_scales(ref)[1]) < len(ref) // 4
    worst = worst_leaf(ref, port, side)
    top = max(worst, key=worst.get)
    print(f"{side}: Adam first moments {worst[top]:.3g} of the leaf scale at {top} (tol {tol})")
    assert worst[top] <= tol, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


@pytest.fixture(scope="module")
def float64_step(steps):
    """The port's step in float64 from the same state and draws: its
    metrics, each side's Adam first moments and parameters, the reference of
    G's comparisons and of test_both_sides_match_a_float64_step. Attention
    goes through a float64 softmax; the losses stay float32, as on both
    sides (their rounding is about 1e-7 relative)."""
    from txt2vid_tpu_torch.models import layers as port_layers

    def attention64(theta, phi, g, use_kernel=True):
        return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_layers, "attention_core_auto", attention64)
        gen, disc, enc = (m.double() for m in port_models(steps["old"]))
        opts = {"G": adam(gen.parameters()), "D": adam(disc.parameters())}
        step = build_train_step(CondGan(gen, enc, discrims=[disc]),
                                port_losses.RSGANLoss(), opts["G"], opts["D"],
                                TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                            latent_size=GEN["latent_size"],
                                            shared_gen_fwd=True))
        video, caps, lens = make_batch()
        d = steps["draws"]
        metrics = step({"video": torch.from_numpy(video).double(),
                        "captions": torch.from_numpy(caps).long(),
                        "lengths": torch.from_numpy(lens)},
                       Draws(torch.from_numpy(d["z"]).double(), d["pyramid"], d["gen"],
                             [torch.from_numpy(np.array(d["perm"])).long()]))
    sides = (("G", gen), ("D", disc))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "moments": {side: {n: opts[side].state[p]["exp_avg"]
                               for n, p in m.named_parameters()} for side, m in sides},
            "params": {side: {n: p.detach() for n, p in m.named_parameters()}
                       for side, m in sides}}


@pytest.mark.parametrize("side", ["G", "D"])
def test_both_sides_match_a_float64_step(steps, float64_step, side):
    """At KERNEL_SCALE each side's float32 Adam first moments are within 1e-4
    of the (floored) leaf scale of the float64 step's: the tolerance between
    the two sides is what float32 rounding leaves either of them; the
    port's G, at one thread, within G_F64_TOL (the module docstring)."""
    ref = float64_step["moments"][side]
    port, jax_side = _all_moments(steps)[side]
    for who, got, tol in (("port", port, G_F64_TOL if side == "G" else 1e-4),
                          ("jax", jax_side, 1e-4)):
        worst = worst_leaf(ref, got, f"{who} {side}")
        top = max(worst, key=worst.get)
        print(f"{who} {side} vs float64: {worst[top]:.3g} of the leaf scale at {top} "
              f"(tol {tol})")
        assert worst[top] <= tol, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_batch_norm_running_stats(steps):
    stats = jax_to_torch_generator(steps["new"].g_vars["params"],
                                   steps["new"].g_vars["batch_stats"])
    port = steps["gen"].state_dict()
    names = [k for k in stats if k.endswith(("running_mean", "running_var"))]
    assert names
    before = jax_to_torch_generator(steps["old"].g_vars["params"],
                                    steps["old"].g_vars["batch_stats"])
    for k in names:
        assert not torch.equal(before[k], stats[k]), f"{k} did not move"
        ref, got = stats[k].numpy(), port[k].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(ref - got).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("side", ["G", "D"])
def test_params_after_step(steps, float64_step, side):
    """D's parameters against JAX's; G's against the float64 step's, as
    test_torch_gp_step holds them: sign-free where the float64 moment is
    below 3e-2 of the leaf scale (the port's G moments stray up to
    G_F64_TOL of it), within G_PARAM_TOL elsewhere."""
    new = steps["new"]
    if side == "G":
        ref = {n: p.numpy() for n, p in float64_step["params"]["G"].items()}
        grads, free_below, tol = float64_step["moments"]["G"], 3e-2, G_PARAM_TOL
        port = dict(steps["gen"].named_parameters())
    else:
        ref = {n: p.numpy() for n, p in jax_to_torch_discriminator(
            new.d_vars[0]["params"]).items()}
        grads, free_below, tol = _all_moments(steps)[side][1], 1e-4, 1e-6
        port = dict(steps["disc"].named_parameters())
    scales, null, _ = _leaf_scales(grads)
    worst = 0.0
    for name, p in port.items():
        r, got = ref[name], p.detach().double().numpy()
        free = (np.abs(grads[name].double().numpy()) < free_below * scales[name]) | (name in null)
        diff = np.abs(r - got)
        worst = max(worst, float(diff[~free].max(initial=0.0)))
        assert float(diff[~free].max(initial=0.0)) <= tol, name
        assert float(diff[free].max(initial=0.0)) <= 2 * LR + 1e-6, name
    print(f"{side} parameters: {worst:.3g} where not sign-free (tol {tol})")


def test_step_went_through_the_attention_function(steps):
    """One generator attention plus the discriminator's at three scales: the
    forwards (G 1, D phase 3 + 3, real preds 3, G phase 3) and their
    backwards (D phase 6, G phase 3, generator 1). On the CPU the counters
    stay at 0: the wrappers take their plain versions."""
    assert steps["counts"] == [0, 0, 0]
    attn = [m for m in steps["gen"].modules() if type(m).__name__ == "Attention"]
    attn3d = [m for m in steps["disc"].modules() if type(m).__name__ == "Attention3d"]
    assert len(attn) == 1 and len(attn3d) == 1
    assert float(attn[0].gamma.grad) != 0.0 and float(attn3d[0].gamma.grad) != 0.0
    assert float(attn[0].theta.weight.grad.abs().max()) > 0.0
    assert float(attn3d[0].phi.weight.grad.abs().max()) > 0.0


@pytest.mark.parametrize("field,value", [
    ("gp_lambda", 10.0), ("gp_every", 4), ("gp_quarantine", True), ("clip_grad", 1.0),
    ("discrim_steps", 2), ("img_model", True), ("end2end", True), ("gen_steps", 2)])
def test_ported_fields_accepted(field, value):
    """The regularization fields the training CLI's slice ported
    (tests/test_torch_gp_step.py holds them to the JAX step), img_model
    (tests/test_torch_families_step.py), end2end and gen_steps
    (tests/test_torch_end2end.py)."""
    check_config(TrainConfig(**{field: value}))


def test_compute_dtype_runs_from_a_bf16_parameter_copy():
    """compute_dtype (--bf16_params): every forward of the step reads bf16
    weights; the stored parameters, their gradients and Adam's moments stay
    float32, and the float32 modules compute in float32 (flax's promotion)."""
    from txt2vid_tpu_torch.ops.initializers import init_from_seed
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), 1)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), 2)
    enc = init_from_seed(Seq2Seq(**ENC), 3)
    step = build_train_step(CondGan(gen, enc, discrims=[disc]), port_losses.RSGANLoss(),
                            adam(gen.parameters()), adam(disc.parameters()),
                            TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                        latent_size=GEN["latent_size"],
                                        compute_dtype=torch.bfloat16))
    seen = []
    for conv in (gen.up0.conv1, disc.discrim.stem_conv1):
        conv.register_forward_hook(
            lambda m, i, o: seen.append((m.weight.dtype, i[0].dtype, o.dtype)))
    video, caps, lens = make_batch(2)
    metrics = step({"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
                    "lengths": torch.from_numpy(lens)})
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert seen and set(seen) == {(torch.bfloat16, torch.float32, torch.float32)}
    for m, opt in ((gen, step.opt_g), (disc, step.opt_d)):
        for p in m.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
            assert opt.state[p]["exp_avg"].dtype == torch.float32


def _tiny_port_step(shared, seed=0):
    torch.manual_seed(seed)
    from txt2vid_tpu_torch.ops.initializers import init_from_seed
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), 1)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), 2)
    enc = init_from_seed(Seq2Seq(**ENC), 3)
    for m in list(gen.modules()) + list(disc.modules()):
        if hasattr(m, "gamma"):
            torch.nn.init.constant_(m.gamma, 0.5)
    gan = CondGan(gen, enc, discrims=[disc])
    step = build_train_step(gan, port_losses.RSGANLoss(), adam(gen.parameters()),
                            adam(disc.parameters()),
                            TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                        latent_size=GEN["latent_size"],
                                        shared_gen_fwd=shared), seed=7)
    video, caps, lens = make_batch(1)
    batch = {"video": torch.from_numpy(video), "captions": torch.from_numpy(caps).long(),
             "lengths": torch.from_numpy(lens)}
    forwards = []
    gen.register_forward_hook(lambda *_: forwards.append(1))
    metrics = [step(batch) for _ in range(2)]
    assert len(forwards) == 2, "one generator forward per step"
    return metrics, gen


def test_shared_and_two_forward_steps_agree():
    """Outside end2end the two-forward form computes what shared_gen_fwd does,
    so the port runs one generator forward per step for either value of the
    flag: the numbers, BatchNorm running statistics included, agree."""
    (m_shared, g_shared), (m_two, g_two) = _tiny_port_step(True), _tiny_port_step(False)
    for a, b in zip(m_shared, m_two):
        for k in a:
            assert abs(float(a[k]) - float(b[k])) <= 1e-5 * abs(float(a[k])), k
    sa, sb = g_shared.state_dict(), g_two.state_dict()
    for k in sa:
        assert torch.allclose(sa[k].float(), sb[k].float(), rtol=1e-5, atol=1e-6), k


def test_bench_cli(monkeypatch, capsys):
    """`python -m txt2vid_tpu_torch.bench --profile 1`'s path on the CPU, with
    the flagship swapped for the small models and fewer steps."""
    import json
    from functools import partial
    from txt2vid_tpu_torch import bench
    monkeypatch.setattr(bench.tganv2_cond, "MultiScaleGen", partial(
        tganv2.MultiScaleGen, **{**GEN, "latent_size": 256, "cond_dim": 256},
        with_non_local=True))
    monkeypatch.setattr(bench.tganv2_cond, "MultiScaleDiscrim",
                        partial(tganv2.MultiScaleDiscrim, **{**DISC, "cond_dim": 256}))
    monkeypatch.setattr(bench, "Seq2Seq", partial(Seq2Seq, embed_size=8, num_layers=1))
    for name, value in (("BATCH", 4), ("NUM_FRAMES", 8), ("FRAME_SIZES", FRAME_SIZES),
                        ("WARMUP", 1), ("SHORT", 1), ("LONG", 3)):
        monkeypatch.setattr(bench, name, value)
    bench.cli(["--device", "cpu", "--profile", "1"])
    line, prof = map(json.loads, capsys.readouterr().out.strip().splitlines()[-2:])
    assert line["metric"] == "train_steps_per_sec_per_gpu_cond_tganv2_16f_64px"
    assert line["value"] > 0 and line["dtype"] == "f32" and line["batch_size"] == 4
    assert np.isfinite(line["loss_g"]) and line["device"] == "cpu"
    # a CPU run traces no device kernels; the operators are listed all the same
    assert prof["profile_steps"] == 1 and prof["wall_ms_per_step"] > 0
    assert prof["device_ms_per_step"] == 0 and prof["top_ops"]
