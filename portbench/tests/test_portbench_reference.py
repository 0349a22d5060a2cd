"""The plain reference against the program (txt2vid_tpu_torch) on the CPU at
tiny widths: the models' forwards, one train step and one gradient-penalty
step, from the same weights, batch and draws."""

import numpy as np
import pytest
import torch

from portbench import data, weights
from portbench.reference import train as ref_train
from portbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def program_models(spec, vocab_size):
    from txt2vid_tpu_torch.config import create_object
    txt = create_object(spec["sent"], vocab_size=vocab_size)
    gen = create_object(spec["G"], cond_dim=txt.encoding_size)
    disc = create_object(spec["D"], cond_dim=txt.encoding_size)
    return gen, disc, txt


def shared_weights(spec, vocab_size, seed=3):
    G, D, E = ref_train.build(spec, vocab_size, "cpu")
    w = weights.model_weights({"G": G, "D": D, "E": E}, seed, "cpu")
    gen, disc, txt = program_models(spec, vocab_size)
    for name, m in (("G", gen), ("D", disc), ("E", txt)):
        weights.load(m, weights.part(w, name))
    for name, m in (("G", G), ("D", D), ("E", E)):
        weights.load(m, weights.part(w, name))
    return (G, D, E), (gen, disc, txt), w


def batch(spec, seed=5):
    rng = np.random.default_rng(seed)
    g, t = spec["G"]["args"], spec["train"]
    videos = data.clips(t["batch_size"], (g["num_frames"], g["width"], g["width"],
                                           g["num_channels"]), rng)
    ids, lengths = data.tokenize(data.captions(t["batch_size"], rng), t["max_caption_len"])
    return torch.from_numpy(videos), torch.from_numpy(ids), torch.from_numpy(lengths)


def test_forwards_match():
    spec = tiny.spec()
    vocab = len(data.vocabulary())
    (G, D, E), (gen, disc, txt), _ = shared_weights(spec, vocab)
    video, ids, lengths = batch(spec)
    cond_ref = E(ids, lengths)
    cond = txt.encode(ids, lengths)[2]
    assert torch.allclose(cond, cond_ref, atol=1e-6)
    z = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    G.eval(), gen.eval()
    assert torch.allclose(gen(z, cond=cond, train=False)[-1], G(z, cond_ref)[-1], atol=1e-5)
    G.train(), gen.train()
    outs_ref = G(z, cond_ref, phases=[1, 0])
    outs = gen(z, cond=cond, train=True, phases=[1, 0])
    for a, b in zip(outs, outs_ref):
        assert a.shape == b.shape
        # BatchNorm over the few items of the last scales amplifies the
        # summation order's rounding
        assert torch.allclose(a, b, atol=1e-4)
    xs = [o.detach() for o in outs_ref]
    conds = [cond_ref[: x.shape[0]] for x in xs]
    for (u, c, f), (ur, cr, fr) in zip(disc(xs, cond=conds), D(xs, conds)):
        assert torch.allclose(u, ur, rtol=1e-5, atol=1e-4)
        assert torch.allclose(c, cr, rtol=1e-5, atol=1e-4)


def program_step(spec, models, seed):
    from txt2vid_tpu_torch.gan.cond_gan import CondGan
    from txt2vid_tpu_torch.gan.losses import MixedGanLoss, RSGANLoss
    from txt2vid_tpu_torch.gan.train_step import TrainConfig, adam, build_train_step
    gen, disc, txt = models
    t = spec["train"]
    cfg = TrainConfig(frame_sizes=tuple(t["frame_sizes"]), subsample_input=True,
                      gp_lambda=t["gp_lambda"], gp_every=t["gp_every"],
                      latent_size=gen.latent_size, clip_grad=t["clip_grad"])
    gan = CondGan(gen, txt, discrims=[disc])
    return build_train_step(gan, MixedGanLoss(RSGANLoss(), RSGANLoss()),
                            adam(gen.parameters(), t["G_lr"], 0.5, 0.999),
                            adam(disc.parameters(), t["D_lr"], 0.5, 0.999), cfg, seed=seed)


@pytest.mark.parametrize("steps", [1, 2], ids=["gp_step", "gp_then_plain"])
def test_train_steps_match(steps):
    """In float64 on both sides, where the generator's BatchNorm over few
    items does not amplify float32's rounding (the program's attention on its
    plain path, as its kernels' CPU versions take no float64)."""
    spec = tiny.spec()
    vocab = len(data.vocabulary())
    (G, D, E), models, w = shared_weights(spec, vocab)
    w = {k: v.double() for k, v in w.items()}
    for m in (G, D, E, *models):
        m.double()
    ref = ref_train.ReferenceTrainer(spec, vocab, w, "cpu", dtype=torch.float64)
    step = program_step(spec, models, seed=11)
    video, ids, lengths = batch(spec)
    from txt2vid_tpu_torch.ops.attention import no_kernel
    for _ in range(steps):
        with no_kernel():       # the kernels' CPU versions take float32 and bf16 only
            m = step({"video": video, "captions": ids, "lengths": lengths})
        r = ref.step(video, ids, lengths, ref.draws(11, 4))
        rel = 1e-6
        for key in ("loss_d", "loss_g", "grad_norm_d", "grad_norm_g"):
            assert float(m[key]) == pytest.approx(float(r[key]), rel=rel, abs=1e-6), key
    # the benchmark's rule: the gap of each live leaf's change, against the
    # reference's change of that leaf or of the median leaf
    for module, params, grads, start in ((models[0], ref.g_params, r["grad_g"], G),
                                         (models[1], ref.d_params, r["grad_d"], D)):
        p0 = dict(start.named_parameters())
        norms = torch.stack([g.norm() for g in grads])
        live = norms >= 1e-3 * norms.median()
        prog = torch.stack([(p - p0[n]).norm() for n, p in module.named_parameters()])
        want = torch.stack([(q - p0[n]).norm() for (n, _), q in zip(module.named_parameters(),
                                                                    params)])
        gap = (prog - want).abs() / torch.maximum(want, want[live].median())
        assert float(gap[live].max().detach()) < 1e-6
