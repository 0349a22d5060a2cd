"""Whole steps of the TCWYT and image-GAN families in txt2vid_tpu_torch against
txt2vid_tpu's `build_train_step`, their checkpoints both ways and the CLIs
with scripts/run.sh's and scripts/run_tgan.sh's flags, on the CPU.

- run.sh's configuration, tiny: tcwyt.Gen (z 6, scale_factor 1/16), the
  video (mid_ch 4), frame and motion discriminators, the FrameMap sample
  mapping, a one-layer Seq2Seq, RaLSGAN, Adam(1e-4, 0.5, 0.9), batch 2 of
  4-frame 48-px clips. One port step against the jitted JAX step from one
  random state (test_torch_models' random_variables) and the JAX step's
  draws: z from its key split, each discriminator's caption derangement
  recorded by wrapping gen_perm_device.
- run_tgan.sh's, tiny: img.Gen and img.Discrim at dim 4, --img_model on
  64-px images, WassersteinGanLoss with gp_lambda 10 and discrim_steps 2,
  no captions. The GP's interpolation weights are recorded by wrapping the
  JAX package's _interpolate.

Tolerances, as test_torch_train_step and test_torch_gp_step state them:
losses 1e-5 relative, grad norms 1e-4 relative, the generator's BatchNorm
statistics 1e-5 of their scale. Adam's first moments: both sides are held to
the port's step in float64 from the same state and draws, the port within
1e-4 of the leaf scale (its max|moment| floored at 1e-2 of the module's
largest; null leaves, below 1e-5 of it, hold noise), JAX within 5e-4. The
JAX step's own float32 moments stray further (measured 1.5e-4 at tcwyt.Gen's
input_map, whose BatchNorm takes statistics over a batch of 2 with flax's
fast variance E[x^2] - E[x]^2, and 2.8e-4 at the image critic's first
LayerNorm bias) than the port's (2.5e-5). The discriminators' and M's
statistics must come out of the step as they went in, on both sides.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from test_torch_models import jax_variables
from test_torch_train_step import _leaf_scales
from txt2vid_tpu.gan import losses as jax_losses
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import GanTrainState
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step
from txt2vid_tpu.gan.train_step import init_state_abstract
from txt2vid_tpu.models import img as jax_img
from txt2vid_tpu.models import tcwyt as jax_tcwyt
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu.utils import misc as jax_misc
from txt2vid_tpu_torch import sample as port_sample
from txt2vid_tpu_torch.convert import (jax_state_to_torch, module_to_flax, torch_state_to_jax,
                                       vars_to_torch)
from txt2vid_tpu_torch.data import build_vocab, encode_caption, pad_captions
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan import trainer as port_trainer
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import Draws, TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import img, tcwyt
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.train import gan as port_gan
from txt2vid_tpu_torch.utils import checkpoint

B, T, KEY = 2, 4, 5
ENC = dict(vocab_size=20, embed_size=8, hidden_size=8, num_layers=1)
C = ENC["hidden_size"]                      # the encoder's encoding size
TCWYT_G = dict(z_size=6, scale_factor=1 / 16)
XBAR = (B, T, 3, 3, 512)                    # FrameMap of 48-px frames
IMG = dict(dim=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, shape, captions=True):
    rng = np.random.default_rng(seed)
    out = {"video": rng.uniform(-1, 1, shape).astype(np.float32)}
    if captions:
        caps = rng.integers(1, ENC["vocab_size"], (B, 6)).astype(np.int32)
        lens = np.array([6, 3], np.int32)
        caps[1, 3:] = 0
        out.update(captions=caps, lengths=lens)
    return out


def _port_batch(batch):
    out = {"video": torch.from_numpy(batch["video"])}
    if "captions" in batch:
        out.update(captions=torch.from_numpy(batch["captions"]).long(),
                   lengths=torch.from_numpy(batch["lengths"]))
    return out


# ------------------------------------------------------------ the two families

def tcwyt_jax():
    gen = jax_tcwyt.Gen(**TCWYT_G)
    discrims = [jax_tcwyt.VideoDiscrim(cond_dim=C, mid_ch=4), jax_tcwyt.FrameDiscrim(cond_dim=C),
                jax_tcwyt.MotionDiscrim(cond_dim=C)]
    return JaxCondGan(gen=gen, discrims=discrims, cond_encoder=JaxSeq2Seq(**ENC),
                      sample_mapping=jax_tcwyt.FrameMap(),
                      discrim_names=["video", "frame", "motion"])


def tcwyt_port():
    discrims = [tcwyt.VideoDiscrim(cond_dim=C, mid_ch=4), tcwyt.FrameDiscrim(cond_dim=C),
                tcwyt.MotionDiscrim(cond_dim=C)]
    return CondGan(tcwyt.Gen(**TCWYT_G, cond_dim=C), Seq2Seq(**ENC), discrims=discrims,
                   sample_mapping=tcwyt.FrameMap(), discrim_names=["video", "frame", "motion"])


def img_jax():
    return JaxCondGan(gen=jax_img.Gen(**IMG), discrims=[jax_img.Discrim(**IMG)])


def img_port():
    return CondGan(img.Gen(**IMG), discrims=[img.Discrim(**IMG)])


FAMILIES = {
    "tcwyt": dict(jax=tcwyt_jax, port=tcwyt_port, loss="RaLSGANLoss", latent=6,
                  batch=lambda: _batch(0, (B, T, 48, 48, 3)),
                  config=dict(frame_sizes=(48,))),
    "img": dict(jax=img_jax, port=img_port, loss="WassersteinGanLoss", latent=128,
                batch=lambda: _batch(1, (B, 64, 64, 3), captions=False),
                config=dict(frame_sizes=(64,), img_model=True, discrim_steps=2,
                            gp_lambda=10.0)),
}


def jax_state(gan, batch, opt):
    """A random GanTrainState for `gan` (every variable random: see
    test_torch_models.random_variables)."""
    x = jnp.asarray(batch["video"])
    latent = gan.gen.latent_size
    cond = jnp.zeros((B, C)) if gan.cond_encoder is not None else None
    g_vars = jax_variables(gan.gen, 1, jnp.zeros((B, latent)), cond, train=True)
    txt_vars = m_vars = xbar = None
    if gan.cond_encoder is not None:
        txt_vars = jax_variables(gan.cond_encoder, 2, jnp.asarray(batch["captions"]),
                                 jnp.asarray(batch["lengths"]))
    if gan.sample_mapping is not None:
        m_vars = jax_variables(gan.sample_mapping, 3, x, train=True)
        xbar = jnp.zeros(XBAR)
    d_vars = tuple(jax_variables(d, 4 + i, x=x, cond=cond, xbar=xbar, train=True)
                   for i, d in enumerate(gan.discrims))
    def zeros_like_init(params):    # opt.init's tree, without compiling its ops
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                      jax.eval_shape(opt.init, params))

    return GanTrainState(
        step=np.zeros((), np.int32), g_vars=g_vars, d_vars=d_vars, txt_vars=txt_vars,
        m_vars=m_vars, opt_g_state=zeros_like_init({"g": g_vars["params"]}),
        opt_d_state=zeros_like_init({"d": tuple(v["params"] for v in d_vars)}))


def _port_step(family, dtype=torch.float32):
    spec = FAMILIES[family]
    gan = spec["port"]()
    for m in (gan.gen, *gan.discrims, gan.cond_encoder, gan.sample_mapping):
        if m is not None:
            m.to(dtype)
    opts = (adam(gan.gen.parameters(), 1e-4, 0.5, 0.9),
            adam([p for d in gan.discrims for p in d.parameters()], 1e-4, 0.5, 0.9))
    return build_train_step(gan, getattr(port_losses, spec["loss"])(), *opts,
                            TrainConfig(latent_size=spec["latent"], **spec["config"]))


def _run_port(family, old, batch, z, draws, dtype=torch.float32):
    """A port step from the JAX state `old` with the JAX step's draws."""
    step = _port_step(family, dtype)
    jax_state_to_torch(old, step)
    n_d = len(step.gan.discrims)
    perms = [torch.from_numpy(np.array(p)).long() for p in draws["perm"]] or [None] * n_d
    alphas = [torch.from_numpy(np.array(a)).to(dtype) for a in draws["alpha"]]
    d_steps = [(perms, [[a]] if alphas else None) for a in (alphas or [None])]
    pb = _port_batch(batch)
    pb["video"] = pb["video"].to(dtype)
    before = {k: v.clone() for k, v in port_statistics(step.gan).items()}
    metrics = step(pb, Draws(z.to(dtype), [], [], *d_steps[0], later_d_steps=d_steps[1:]))
    return step, before, {k: float(v) for k, v in metrics.items()}


def run_both(family):
    """The JAX step, the port's and the port's in float64 from one state,
    batch and draws."""
    spec = FAMILIES[family]
    gan = spec["jax"]()
    opt = optax.adam(1e-4, b1=0.5, b2=0.9)
    batch = spec["batch"]()
    state = jax_state(gan, batch, opt)
    cfg = JaxTrainConfig(latent_size=spec["latent"], **spec["config"])
    step = jax_build_train_step(gan, getattr(jax_losses, spec["loss"])(), opt, opt, cfg)
    rec = {"perm": [], "alpha": []}
    mp = pytest.MonkeyPatch()
    perm, interp = jax_misc.gen_perm_device, jax_losses._interpolate
    mp.setattr(jax_misc, "gen_perm_device", lambda *a: rec["perm"].append(perm(*a))
               or rec["perm"][-1])

    def interpolate(alpha, real, fake):
        if real.ndim == batch["video"].ndim:
            rec["alpha"].append(alpha.reshape(-1))
        return interp(alpha, real, fake)

    mp.setattr(jax_losses, "_interpolate", interpolate)

    def run(state, batch, key):
        for v in rec.values():
            v.clear()
        new, metrics = step(state, batch, key)
        return new, metrics, {k: list(v) for k, v in rec.items()}

    try:
        new, metrics, draws = jax.jit(run)(state, jax.tree_util.tree_map(jnp.asarray, batch),
                                           jax.random.key(KEY))
    finally:
        mp.undo()
    k_z = jax.random.split(jax.random.fold_in(jax.random.key(KEY), 0), 5)[0]
    z = torch.from_numpy(np.array(jax.random.normal(k_z, (B, spec["latent"]))))
    old = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, state))
    port_step, before, port_metrics = _run_port(family, old, batch, z, draws)
    step64, _, metrics64 = _run_port(family, old, batch, z, draws, torch.float64)
    new = jax.tree_util.tree_map(np.asarray, new)
    return dict(gan=port_step.gan, step=port_step, step64=step64, old=old, before=before,
                new_state=new, new=serialization.to_state_dict(new), metrics64=metrics64,
                metrics={k: float(v) for k, v in metrics.items()},
                port_metrics=port_metrics, draws=draws)


def port_statistics(gan):
    """name -> running statistic of every BatchNorm in the discriminators and M."""
    out = {}
    for tag, m in [*((f"d{i}", d) for i, d in enumerate(gan.discrims)),
                   ("m", gan.sample_mapping)]:
        if m is not None:
            out.update({f"{tag}.{n}": b for n, b in m.named_buffers() if "running" in n})
    return out


@pytest.fixture(scope="module", params=list(FAMILIES))
def steps(request):
    return request.param, run_both(request.param)


def test_draws(steps):
    family, s = steps
    if family == "tcwyt":
        assert len(s["draws"]["perm"]) == 3 and not s["draws"]["alpha"]
    else:
        assert len(s["draws"]["alpha"]) == 2 and not s["draws"]["perm"]


def test_losses_and_norms(steps):
    """loss_d (summed over the D steps), the grad norms, and loss_g, which
    reads the discriminator after its Adam updates. Adam's first update moves
    each element by about lr * sign(g), and where g is float noise (the image
    critic's rb4.ln2.bias on the port's side, rb1.ln1 on JAX's, each about
    lr from the float64 step) the G loss moves with it: measured 2.2e-5
    (port) and 1.6e-6 (JAX) relative from the float64 step's, which both
    sides are held to within 5e-5."""
    _, s = steps
    for k, tol in (("loss_d", 1e-5), ("grad_norm_d", 1e-4), ("grad_norm_g", 1e-4)):
        ref, got = s["metrics"][k], s["port_metrics"][k]
        assert np.isfinite(got) and abs(got - ref) <= tol * abs(ref), (k, ref, got)
    r64 = s["metrics64"]["loss_g"]
    for got in (s["metrics"]["loss_g"], s["port_metrics"]["loss_g"]):
        assert abs(got - r64) <= 5e-5 * abs(r64), (got, r64)


def test_adam_first_moments_match_a_float64_step(steps):
    """Every module's first moments, G's and each discriminator's, on both
    sides against the port's float64 step."""
    _, s = steps
    gan, step, step64, new = s["gan"], s["step"], s["step64"], s["new"]
    sides = [("G", gan.gen, step64.gan.gen, step.opt_g, step64.opt_g,
              new["opt_g_state"]["0"]["mu"]["g"])]
    sides += [(f"D{k}", d, step64.gan.discrims[k], step.opt_d, step64.opt_d,
               new["opt_d_state"]["0"]["mu"]["d"][str(k)]) for k, d in enumerate(gan.discrims)]
    for side, module, module64, opt, opt64, mu in sides:
        ref = {n: opt64.state[p]["exp_avg"] for n, p in module64.named_parameters()}
        scales, null, bound = _leaf_scales(ref)
        for who, got, tol in (
                ("port", {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()},
                 1e-4),
                ("jax", vars_to_torch(module, mu), 5e-4)):
            assert set(got) == set(ref), (who, side)
            for name, r in ref.items():
                g = got[name].double()
                if name in null:
                    assert float(g.abs().max()) < bound, f"{who} {side} {name} is not null"
                    continue
                err = float((r - g).abs().max())
                assert err <= tol * scales[name], \
                    f"{who} {side} {name}: {err} > {tol} * {scales[name]}"


def test_statistics(steps):
    """G's BatchNorm statistics move as JAX's do; the discriminators' and
    M's do not move on either side (hazard: the JAX step discards them)."""
    family, s = steps
    gan, old, new = s["gan"], s["old"], s["new"]
    got = module_to_flax(gan.gen)[1]
    ref = new["g_vars"]["batch_stats"]
    moved = 0
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        g, o = got, old["g_vars"]["batch_stats"]
        for k in path:
            g, o = g[k.key], o[k.key]
        moved += not np.array_equal(r, o)
        scale = max(1.0, float(np.abs(r).max()))
        assert float(np.abs(r - g.numpy()).max()) <= 1e-5 * scale, path
    assert moved
    for k in range(len(gan.discrims)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, new["d_vars"][str(k)].get(
            "batch_stats", {}), old["d_vars"][str(k)].get("batch_stats", {}))
    after = port_statistics(gan)
    assert set(after) == set(s["before"])
    assert bool(after) == (family == "tcwyt")
    for n, v in after.items():
        assert torch.equal(v, s["before"][n]), f"{n} moved"
    if family == "tcwyt":
        assert all(not p.requires_grad for p in gan.sample_mapping.parameters())
        jax.tree_util.tree_map(np.testing.assert_array_equal, new["m_vars"], old["m_vars"])


def test_checkpoint_both_ways(steps, tmp_path):
    """The JAX step's new state, written by the JAX package, read by the port
    into a fresh step and written again: the same bytes. m_vars and the
    discriminators' statistics included."""
    family, s = steps
    a, b = tmp_path / "jax", tmp_path / "port"
    jax_checkpoint.save_state(s["new_state"], str(a))
    step = _port_step(family)
    gan = step.gan
    jax_state_to_torch(checkpoint.restore_state(torch_state_to_jax(step), a), step)
    checkpoint.save_state(torch_state_to_jax(step), b)
    assert a.read_bytes() == b.read_bytes()
    if family == "tcwyt":
        assert torch.equal(gan.sample_mapping.bn0.running_var,
                           torch.from_numpy(s["new"]["m_vars"]["batch_stats"]["bn0"]["var"]))


def test_frame_discrim_penalty_reads_xbar_only():
    """FrameDiscrim ignores x, so the GP's gradient w.r.t. the
    interpolated x is zero in JAX; each per-sample norm is sqrt(1e-12) and
    the penalty (1e-6 - 1)^2. The port gives the same value, with no graph
    to D's parameters, where torch.autograd.grad would raise without
    allow_unused."""
    rng = np.random.default_rng(7)
    x_r, x_f = (rng.uniform(-1, 1, (B, T, 8, 8, 3)).astype(np.float32) for _ in range(2))
    m_r, m_f = (rng.standard_normal(XBAR).astype(np.float32) for _ in range(2))
    c_r, c_f = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
    jd = jax_tcwyt.FrameDiscrim(cond_dim=C)
    d_vars = jax_variables(jd, 8, cond=jnp.asarray(c_r), xbar=jnp.asarray(m_r), train=True)
    jgan = JaxCondGan(gen=jax_tcwyt.Gen(**TCWYT_G), discrims=[jd])
    key = jax.random.key(9)
    ref = jgan._gradient_penalty(0, d_vars, key, [jnp.asarray(x_r)], [jnp.asarray(x_f)],
                                 [jnp.asarray(c_r)], [jnp.asarray(c_f)], jnp.asarray(m_r),
                                 jnp.asarray(m_f), True)
    alpha = np.asarray(jax.random.uniform(key, (B, 1, 1, 1, 1))).reshape(-1)
    pd = tcwyt.FrameDiscrim(cond_dim=C)
    pd.load_state_dict(vars_to_torch(pd, d_vars["params"], d_vars["batch_stats"]))
    stats = {n: b.clone() for n, b in pd.named_buffers() if "running" in n}
    got = CondGan(None, discrims=[pd]).gradient_penalty(
        0, [torch.from_numpy(alpha)], [torch.from_numpy(x_r)], [torch.from_numpy(x_f)],
        [torch.from_numpy(c_r)], [torch.from_numpy(c_f)], torch.from_numpy(m_r),
        torch.from_numpy(m_f))
    assert float(ref) == pytest.approx((1e-6 - 1.0) ** 2, rel=1e-7)
    assert float(got) == pytest.approx(float(ref), rel=1e-7)
    assert not got.requires_grad
    # the penalty's train-mode forward leaves D's statistics alone
    assert all(torch.equal(b, stats[n]) for n, b in pd.named_buffers() if n in stats)


# ------------------------------------------------------------------- the CLIs

SPEC_S = json.dumps({"class": "txt2vid_tpu.models.txt.Seq2Seq",
                     "args": {"embed_size": 8, "hidden_size": C, "num_layers": 1}})
RUN_SH_G = json.dumps({"class": "txt2vid_tpu.models.tcwyt.Gen",
                       "args": {"scale_factor": 1 / 16}})
RUN_SH_D = [json.dumps({"class": "txt2vid_tpu.models.tcwyt.VideoDiscrim",
                        "args": {"mid_ch": 4}}),
            "txt2vid_tpu.models.tcwyt.FrameDiscrim", "txt2vid_tpu.models.tcwyt.MotionDiscrim"]
RUN_TGAN_G = json.dumps({"class": "txt2vid_tpu.models.img.Gen", "args": IMG})
RUN_TGAN_D = json.dumps({"class": "txt2vid_tpu.models.img.Discrim", "args": IMG})


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """4 synthetic clips at 48 and at 64 px, captions and a vocabulary."""
    root = tmp_path_factory.mktemp("family_clips")
    for size in (48, 64):
        sents = generate_examples(root / f"v{size}", root / "sent.pickle", num_examples=4,
                                  frame_size=(size, size), num_frames=T, seed=3,
                                  num_channels=3)
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab([c for v in sents.values() for c in v]), f)
    return root


def _data(clips, size):
    return json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(clips / f"v{size}"), "num_frames": T}})


def run_sh_argv(clips, out, *extra):
    """scripts/run.sh's flags, the module name changed, tiny specs."""
    return ["--G", RUN_SH_G, "--D", *RUN_SH_D, "--D_names", "video", "frame", "motion",
            "--M", "txt2vid_tpu.models.tcwyt.FrameMap", "--sent", SPEC_S,
            "--data", _data(clips, 48), "--anno", str(clips / "sent.pickle"),
            "--vocab", str(clips / "vocab.pickle"), "--frame_sizes", "48",
            "--num_channels", "3", "--D_loss", "txt2vid_tpu.gan.losses.RaLSGANLoss",
            "--G_lr", "0.0001", "--D_lr", "0.0001", "--batch_size", str(B), "--epochs", "1",
            "--out", str(out), "--out_samples", str(out / "samples"), "--device", "cpu",
            "--log_period", "1", *extra]


def run_tgan_argv(data, out, *extra):
    """scripts/run_tgan.sh's flags, the module name changed, tiny specs."""
    return ["--G", RUN_TGAN_G, "--D", RUN_TGAN_D, "--dont_use_sent", "--img_model",
            "--data", data, "--frame_sizes", "64", "--num_channels", "3",
            "--D_loss", "txt2vid_tpu.gan.losses.WassersteinGanLoss", "--discrim_steps", "5",
            "--gp_lambda", "10", "--batch_size", str(B), "--epochs", "1", "--out", str(out),
            "--out_samples", str(out / "samples"), "--device", "cpu", "--log_period", "1",
            *extra]


def _steps(monkeypatch):
    made = []
    orig = port_gan.build_train_step
    monkeypatch.setattr(port_gan, "build_train_step",
                        lambda *a, **k: made.append(orig(*a, **k)) or made[-1])
    return made


def _jax_template(gan, video, captions=True):
    batch = {"video": jnp.zeros(video)}
    if captions:
        batch.update(captions=jnp.ones((B, 8), jnp.int32), lengths=jnp.full((B,), 8, jnp.int32))
    opt = optax.adam(1e-4)
    cfg = JaxTrainConfig(frame_sizes=(video[-2],), latent_size=gan.gen.latent_size,
                         img_model=len(video) == 4)
    return init_state_abstract(gan, jax.random.key(0), batch, opt, opt, cfg)


def _same_as_port(jax_state, step):
    ours = serialization.to_state_dict(jax_state)
    mine = checkpoint.to_host(torch_state_to_jax(step))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                                      np.asarray(b)),
                           ours, mine)


def test_run_sh_cli(clips, tmp_path, monkeypatch):
    """Two steps, then --resume for two more; the checkpoint opens in the JAX
    package (its template: the same specs through txt2vid_tpu's CondGan, --M
    included) and holds the port's state; sample --M on it gives the JAX
    generator's videos for the same z and captions."""
    made = _steps(monkeypatch)
    out = tmp_path / "out"
    port_gan.cli(run_sh_argv(clips, out))
    port_gan.cli(run_sh_argv(clips, out, "--resume"))
    assert [s.step for s in made] == [2, 4]
    latest = checkpoint.latest_checkpoint(out)
    assert latest.split("/")[-1].startswith("iter_4_")
    vocab = len(pickle.load(open(clips / "vocab.pickle", "rb")))
    jgan = JaxCondGan(gen=jax_tcwyt.Gen(scale_factor=1 / 16),
                      discrims=[jax_tcwyt.VideoDiscrim(cond_dim=C, mid_ch=4),
                                jax_tcwyt.FrameDiscrim(cond_dim=C),
                                jax_tcwyt.MotionDiscrim(cond_dim=C)],
                      cond_encoder=JaxSeq2Seq(vocab_size=vocab, embed_size=8, hidden_size=C,
                                              num_layers=1),
                      sample_mapping=jax_tcwyt.FrameMap())
    state = jax_checkpoint.restore_state(_jax_template(jgan, (B, T, 48, 48, 3)), latest)
    _same_as_port(state, made[-1])

    sentences = ["digit 3 is left and right.", "digit 5 is top and bottom."]
    z = np.random.default_rng(4).standard_normal((2, 100)).astype(np.float32)
    monkeypatch.setattr(port_trainer, "draw_z", lambda n, size, gen: torch.from_numpy(z))
    got = port_sample.cli([
        "--weights", latest, "--G", RUN_SH_G, "--D", *RUN_SH_D,
        "--M", "txt2vid_tpu.models.tcwyt.FrameMap", "--sent", SPEC_S,
        "--vocab", str(clips / "vocab.pickle"), "--sentences", *sentences,
        "--frame_sizes", "48", "--num_frames", "16", "--num_channels", "3",
        "--out_samples", str(tmp_path / "samples"), "--format", "gif", "--device", "cpu"])
    assert got.shape == (2, 16, 48, 48, 3)
    assert len(list((tmp_path / "samples").glob("sample_48x48_*.gif"))) == 2
    port_vocab = pickle.load(open(clips / "vocab.pickle", "rb"))
    toks, lens = pad_captions([encode_caption(port_vocab, s) for s in sentences])
    ref = jax.jit(lambda st, z, toks, lens: jgan.gen.apply(
        st.g_vars, z, cond=jgan.encode(st.txt_vars, toks, lens), train=False))(
        state, jnp.asarray(z), jnp.asarray(toks), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


def test_run_tgan_sh_cli(clips, tmp_path, monkeypatch):
    """run_tgan.sh's flags on 64-px clips (each clip's first frame): two
    steps of 5 D updates with the GP, --resume for two more, the checkpoint
    open in the JAX package."""
    made = _steps(monkeypatch)
    out = tmp_path / "out"
    anno = ("--anno", str(clips / "sent.pickle"))
    port_gan.cli(run_tgan_argv(_data(clips, 64), out, *anno))
    port_gan.cli(run_tgan_argv(_data(clips, 64), out, *anno, "--resume"))
    assert [s.step for s in made] == [2, 4]
    state = jax_checkpoint.restore_state(
        _jax_template(img_jax(), (B, 64, 64, 3), captions=False),
        checkpoint.latest_checkpoint(out))
    _same_as_port(state, made[-1])


def test_cifar10_data_is_imgs(tmp_path, monkeypatch):
    """--img_model --data_is_imgs over config/cifar10.json's dataset class,
    on a data_batch_1 in CIFAR's pickle format: images padded to 64 px."""
    made = _steps(monkeypatch)
    root = tmp_path / "cifar" / "cifar-10-batches-py"
    root.mkdir(parents=True)
    rng = np.random.default_rng(6)
    with open(root / "data_batch_1", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                     b"labels": [0, 1, 2, 3]}, f)
    data = json.dumps({"class": "txt2vid_tpu.data.cifar10_dataset",
                       "args": {"data": str(tmp_path / "cifar")}})
    seen = []
    orig = port_gan.device_batches
    monkeypatch.setattr(port_gan, "device_batches",
                        lambda b, *a: (seen.append(x["video"].shape) or x for x in orig(b, *a)))
    port_gan.cli(run_tgan_argv(data, tmp_path / "out", "--data_is_imgs"))
    assert made[0].step == 2 and seen == [(B, 64, 64, 3)] * 2
