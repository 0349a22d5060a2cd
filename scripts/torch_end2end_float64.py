"""How far one float32 `--end2end --gen_steps 2` train step sits from float64,
at the flagship's full width, for the JAX package and for the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_end2end_float64.py [--batch 8] \\
        [--warm_steps N] [--out chiprun_out/end2end_float64.json]

Both packages take one step of training/gan.py's command line as chip_smoke.py's
phase cli runs it (the 64-px tganv2_cond G and D at their default widths, fm
1024, Attention(32) in G and Attention3d(128) in D, Seq2Seq 256/256/4, frame
sizes 8/16/32/64 with the subsample pyramid, RSGAN, Adam 2e-4 (0.5, 0.999),
the gradient penalty 0.5 every 2 steps at a GP step, clip 100) plus --end2end --gen_steps 2,
from one state (start_state: the port's init from --seed with every attention
gamma 1, then Adam resumed or --warm_steps float32 steps of the command line),
one batch of uniform clips and random captions, and JAX's draws
(z, the derangement, the GP weights and the recorded subsample phases) in
both. The reference is the port's step in float64 (a float64 softmax; the
losses in float32 as on both sides). The distance is chip_smoke.py's: the
largest max|diff| of an Adam first moment (G's, D's and, where an optimizer
holds it, the encoder's) over its leaf scale (max|leaf| of the float64 step's
moment, floored at 1e-2 of its side's largest). The same is then taken
without --end2end. JAX runs its attention's plain reference (use_pallas
false), jitted once per configuration.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import serialization

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from txt2vid_tpu.config import create_object as jax_create_object  # noqa: E402
from txt2vid_tpu.gan import losses as jax_losses  # noqa: E402
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan  # noqa: E402
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig  # noqa: E402
from txt2vid_tpu.gan.train_step import build_train_step as jax_build_train_step  # noqa: E402
from txt2vid_tpu.gan.train_step import init_state_abstract  # noqa: E402
from txt2vid_tpu.models import tganv2 as jax_tganv2  # noqa: E402
from txt2vid_tpu.ops import subsample as jax_subsample  # noqa: E402
from txt2vid_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from txt2vid_tpu.utils import misc as jax_misc  # noqa: E402
from txt2vid_tpu_torch.config import create_object  # noqa: E402
from txt2vid_tpu_torch.convert import jax_state_to_torch, torch_state_to_jax  # noqa: E402
from txt2vid_tpu_torch.data import build_vocab  # noqa: E402
from txt2vid_tpu_torch.data.synthetic import moving_digit_captions  # noqa: E402
from txt2vid_tpu_torch.gan import losses as port_losses  # noqa: E402
from txt2vid_tpu_torch.gan.cond_gan import CondGan  # noqa: E402
from txt2vid_tpu_torch.gan.train_step import (Draws, TrainConfig, adam,  # noqa: E402
                                              build_train_step, optimizer_params)
from txt2vid_tpu_torch.models import layers as port_layers  # noqa: E402
from txt2vid_tpu_torch.models.layers import Attention, Attention3d  # noqa: E402
from txt2vid_tpu_torch.ops.initializers import init_from_seed  # noqa: E402
from txt2vid_tpu_torch.utils.checkpoint import restore_state, save_state  # noqa: E402

G = "txt2vid_tpu.models.tganv2_cond.MultiScaleGen"
D = "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim"
S = "txt2vid_tpu.models.txt.Seq2Seq"
FRAME_SIZES = (8, 16, 32, 64)
FRAMES, LR, KEY, CAPTION_LEN = 16, 2e-4, 5, 8


def config(end2end, cls, latent_size, gp_lambda=1.0, gp_every=1):
    """The command line's TrainConfig. The measured step is phase cli's GP
    step (--gp_lambda 0.5 --gp_every 2 weighs the lazy penalty gp_lambda *
    gp_every) as gp_lambda 1 every step, so that no lax.cond surrounds the
    penalty, whose branches the recorded phases could not leave."""
    return cls(frame_sizes=FRAME_SIZES, subsample_input=True, gen_steps=2,
               gp_lambda=gp_lambda, gp_every=gp_every, end2end=end2end,
               mean_discrim_loss=True, mean_gen_loss=True, latent_size=latent_size,
               clip_grad=100.0)


def port_step(vocab_size, end2end, gp=(1.0, 1)):
    """A port TrainStep of the command line, its models built by the specs."""
    enc = create_object(S, vocab_size=vocab_size)
    gen = create_object(G, cond_dim=enc.encoding_size)
    disc = create_object(D, cond_dim=enc.encoding_size)
    gan = CondGan(gen, enc, discrims=[disc])
    cfg = config(end2end, TrainConfig, gen.latent_size, *gp)
    g_params, d_params = optimizer_params(gan, cfg)
    return build_train_step(gan, port_losses.RSGANLoss(), adam(g_params, LR, 0.5, 0.999),
                            adam(d_params, LR, 0.5, 0.999), cfg)


def make_batch(rng, batch_size, vocab_size):
    return {"video": rng.uniform(-1, 1, (batch_size, FRAMES, 64, 64, 3)).astype(np.float32),
            "captions": rng.integers(1, vocab_size, (batch_size, CAPTION_LEN)).astype(np.int32),
            "lengths": np.full((batch_size,), CAPTION_LEN, np.int32)}


def start_state(vocab_size, end2end, seed, warm_steps, batch_size):
    """The measured step's state: the CLI's init (init_from_seed per model)
    with every attention gamma 1, then either Adam resumed (warm_steps 0:
    count 1, first moments 0, second moments 1e-4; from init, Adam's first
    update is lr * sign(g), whose sign is noise where a gradient is) or
    warm_steps float32 steps of the command line (GP 0.5 every 2) from a
    fresh Adam on seeded batches. Returns the GanTrainState tree."""
    step = port_step(vocab_size, end2end, gp=(0.5, 2))
    gan = step.gan
    for k, m in enumerate([gan.gen, gan.discrims[0], gan.cond_encoder]):
        init_from_seed(m, int(np.random.SeedSequence([seed, k]).generate_state(1)[0]))
    with torch.no_grad():
        for m in (*gan.gen.modules(), *gan.discrims[0].modules()):
            if isinstance(m, (Attention, Attention3d)):
                m.gamma.fill_(1.0)
    if warm_steps == 0:
        for opt in (step.opt_g, step.opt_d):
            for group in opt.param_groups:
                for p in group["params"]:
                    opt.state[p] = {"step": torch.tensor(1.0), "exp_avg": torch.zeros_like(p),
                                    "exp_avg_sq": torch.full_like(p, 1e-4)}
    for i in range(warm_steps):
        b = make_batch(np.random.default_rng([seed, 1, i]), batch_size, vocab_size)
        metrics = step({"video": torch.from_numpy(b["video"]),
                        "captions": torch.from_numpy(b["captions"]).long(),
                        "lengths": torch.from_numpy(b["lengths"])})
        print(f"warm step {i}: {({k: float(v) for k, v in metrics.items()})}", flush=True)
    return torch_state_to_jax(step)


def jax_draws(batch, latent_size, counter):
    """z, the derangement and the per-scale GP weights of the JAX step at
    `counter` (train_step's key splits)."""
    key = jax.random.fold_in(jax.random.key(KEY), counter)
    k_z, _, _, k_d, _ = jax.random.split(key, 5)
    dkey, perm_key = jax.random.split(jax.random.fold_in(k_d, 0))
    _, gp_key = jax.random.split(dkey)
    keys = jax.random.split(gp_key, len(FRAME_SIZES))
    alphas = [np.asarray(jax.random.uniform(keys[s], (batch >> s, 1, 1, 1, 1)).reshape(-1))
              for s in range(len(FRAME_SIZES))]
    return (np.asarray(jax.random.normal(k_z, (batch, latent_size))),
            np.asarray(jax_misc.gen_perm_device(perm_key, batch)), alphas)


def run_jax(path, batch, vocab_size, end2end):
    """The JAX step from the file: (first moments {"G", "D", "txt"?} as
    numpy trees, metrics, the recorded pyramid and generator phases)."""
    rec = {"pyramid": [], "gen": []}

    def recording(name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            rec[name].append(out[1])
            return out
        return wrapped

    orig = jax_subsample.subsample_video, jax_tganv2.subsample_video
    jax_subsample.subsample_video = recording("pyramid", orig[0])
    jax_tganv2.subsample_video = recording("gen", orig[1])
    try:
        enc = jax_create_object(S, vocab_size=vocab_size)
        gen = jax_create_object(G, use_pallas=False)
        gan = JaxCondGan(gen=gen,
                         discrims=[jax_create_object(D, use_pallas=False)], cond_encoder=enc)
        opt = optax.adam(LR, b1=0.5, b2=0.999)
        cfg = config(end2end, JaxTrainConfig, gen.latent_size)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        template = init_state_abstract(gan, jax.random.key(0), b, opt, opt, cfg)
        state = jax_checkpoint.restore_state(template, str(path))
        step = jax_build_train_step(gan, jax_losses.RSGANLoss(), opt, opt, cfg)

        def run(state, batch, key):
            for v in rec.values():
                v.clear()
            new, metrics = step(state, batch, key)
            return new, metrics, {k: list(v) for k, v in rec.items()}

        t0 = time.perf_counter()
        new, metrics, draws = jax.jit(run)(state, b, jax.random.key(KEY))
        jax.block_until_ready(new)
        print(f"JAX step (compile and run): {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        jax_subsample.subsample_video, jax_tganv2.subsample_video = orig
    moments = {"G": new.opt_g_state[0].mu, "D": new.opt_d_state[0].mu}
    return (serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, moments)),
            {k: float(v) for k, v in metrics.items()},
            {k: [int(x) for x in v] for k, v in draws.items()})


def port_draws(batch_size, latent_size, counter, recorded):
    z, perm, alphas = jax_draws(batch_size, latent_size, counter)
    n = len(FRAME_SIZES) - 1
    gen = recorded["gen"]
    subs = [gen[n * (j + 1):n * (j + 2)] for j in range(len(gen) // n - 1)]
    return Draws(torch.from_numpy(z), recorded["pyramid"][:n], gen[:n],
                 [torch.from_numpy(perm).long()], [[torch.from_numpy(a) for a in alphas]],
                 later_gen_phases=subs[1:])


def _attention64(theta, phi, g, use_kernel=True):
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def run_port(path, batch, vocab_size, end2end, recorded, float64):
    """The port's step from the file, in float32 or float64: (first moments
    as the JAX layout's trees, metrics)."""
    step = port_step(vocab_size, end2end)
    jax_state_to_torch(restore_state(torch_state_to_jax(step), path), step)
    draws = port_draws(batch["video"].shape[0], step.gan.gen.latent_size, step.step, recorded)
    video = torch.from_numpy(batch["video"])
    orig = port_layers.attention_core_auto
    if float64:
        for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
            m.double()
        for opt in (step.opt_g, step.opt_d):
            for st in opt.state.values():
                st.update({k: v.double() for k, v in st.items() if k != "step"})
        draws.z, video = draws.z.double(), video.double()
        draws.alphas = [[a.double() for a in per] for per in draws.alphas]
        port_layers.attention_core_auto = _attention64
    t0 = time.perf_counter()
    try:
        metrics = step({"video": video, "captions": torch.from_numpy(batch["captions"]).long(),
                        "lengths": torch.from_numpy(batch["lengths"])}, draws)
    finally:
        port_layers.attention_core_auto = orig
    print(f"port step ({'float64' if float64 else 'float32'}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for m in (step.gan.gen, step.gan.discrims[0], step.gan.cond_encoder):
        m.float()
    tree = torch_state_to_jax(step)
    return ({"G": tree["opt_g_state"]["0"]["mu"], "D": tree["opt_d_state"]["0"]["mu"]},
            {k: float(v) for k, v in metrics.items()})


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(v.detach().double() if torch.is_tensor(v) else v,
                                             np.float64)


def distance(got, ref):
    """(worst max|diff| / leaf scale, where) over every first-moment leaf,
    the scale floored at 1e-2 of the side's largest leaf (the encoder's
    subtree counted with its optimizer's side)."""
    worst, where = 0.0, None
    for side in ref:
        r, g = dict(_leaves(ref[side])), dict(_leaves(got[side]))
        assert r.keys() == g.keys(), sorted(r.keys() ^ g.keys())
        top = max(float(np.abs(v).max()) for v in r.values())
        for name, v in r.items():
            err = float(np.abs(v - g[name]).max()) / max(float(np.abs(v).max()), 1e-2 * top)
            if err > worst:
                worst, where = err, f"{side}{name}"
    return worst, where


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warm_steps", type=int, default=0,
                   help="float32 steps of the command line before the measured one "
                        "(0: the init with Adam resumed)")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    args = p.parse_args()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    vocab = build_vocab(moving_digit_captions(1000, args.seed))
    batch = make_batch(np.random.default_rng(args.seed), args.batch, len(vocab))
    results = {"batch": args.batch, "seed": args.seed, "warm_steps": args.warm_steps,
               "device": "cpu"}
    with tempfile.TemporaryDirectory() as tmp:
        for end2end in (True, False):
            name = "end2end_gen_steps_2" if end2end else "gen_steps_2"
            path = Path(tmp) / name
            save_state(start_state(len(vocab), end2end, args.seed, args.warm_steps, args.batch),
                       path)
            jax_mu, jax_m, recorded = run_jax(path, batch, len(vocab), end2end)
            f32_mu, f32_m = run_port(path, batch, len(vocab), end2end, recorded, False)
            f64_mu, f64_m = run_port(path, batch, len(vocab), end2end, recorded, True)
            res = {"metrics": {"jax_f32": jax_m, "port_f32": f32_m, "port_f64": f64_m}}
            for side, mu in (("jax_f32", jax_mu), ("port_f32", f32_mu)):
                res[f"{side}_vs_f64"], res[f"{side}_vs_f64_at"] = distance(mu, f64_mu)
            res["port_f32_vs_jax_f32"], res["port_f32_vs_jax_f32_at"] = distance(f32_mu, jax_mu)
            print(name, json.dumps(res), flush=True)
            results[name] = res
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
