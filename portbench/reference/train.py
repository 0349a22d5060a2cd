"""The plain reference of one conditional GAN train step, in float32.

One step, as the configurations run it (one D update and one G update, the
caption encoder frozen): the sentence vectors; the real pyramid (each scale
resized by nearest sampling, every other item and every other frame from
the step's phase after each scale); one generator forward in training mode;
the discriminator's relativistic loss ((unconditional pairing + the mean of
the matched and mismatched conditional pairings) / 2, each a mean over
scales), plus on every gp_every-th step gp_lambda * gp_every times the
zero-centred gradient penalty summed over scales; D's gradient, its global
norm clipped, Adam; then the updated D's predictions on the reals, the
generator's relativistic loss through the same forward, G's gradient, the
clip, Adam; then the generator's EMA. Adam is optax's (bias-corrected
moments, eps added to the root).

The step's random numbers are drawn as the program documents them for a
(seed, step): a CPU generator seeded from SeedSequence([seed, step]) gives,
in order, z, the pyramid's phases, the generator's phases, the caption
derangement (an n-cycle) and, with the penalty configured, one uniform per
item for each scale.
"""

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.models import (Discriminator, Encoder, Generator,
                                        in_gradient_penalty)


def build(spec: dict, vocab_size: int, device, remat: bool | None = None):
    """(G, D, E) reference modules of a configuration's model spec."""
    g_args = dict(spec["G"]["args"])
    g_args.pop("with_non_local", None)
    g_args.pop("height", None)
    cond_dim = spec["sent"]["args"]["hidden_size"]
    g_args["cond_dim"] = cond_dim
    if remat is not None:
        g_args["remat"] = remat
    d_args = {k: v for k, v in spec["D"]["args"].items() if k != "remat"}
    d_args["cond_dim"] = cond_dim
    return (Generator(**g_args).to(device), Discriminator(**d_args).to(device),
            Encoder(vocab_size, **spec["sent"]["args"]).to(device))


def draws(seed: int, step: int, batch: int, latent: int, n_scales: int,
          subsample: bool, num_blocks: int, gp: bool) -> dict:
    gen = torch.Generator()
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))
    z = torch.randn(batch, latent, generator=gen)
    pyramid = [int(torch.randint(0, 2, (), generator=gen))
               for _ in range(n_scales - 1 if subsample else 0)]
    phases = [int(torch.randint(0, 2, (), generator=gen)) for _ in range(num_blocks - 1)]
    order = torch.randperm(batch, generator=gen)
    perm = torch.empty_like(order)
    perm[order] = order.roll(-1)
    alphas = [torch.rand(batch, generator=gen) for _ in range(n_scales)] if gp else None
    return {"z": z, "pyramid": pyramid, "phases": phases, "perm": perm, "alphas": alphas}


def pyramid(x, cond, sizes, phases, subsample):
    xs, conds = [], []
    for i, size in enumerate(sizes):
        f = x.shape[2] // size
        xs.append(x if i == len(sizes) - 1 else x[:, :, f // 2::f, f // 2::f])
        conds.append(cond)
        if subsample and i != len(sizes) - 1:
            x, cond = x[0::2, phases[i]::2], cond[0::2]
    return xs, conds


def bce_one(logits):
    """Binary cross-entropy against label 1, averaged."""
    return F.softplus(-logits).mean()


def _mean(values):
    return torch.stack(values).mean()


def discrim_loss(D, reals, fakes, conds, fake_conds):
    rcc, fcc = D(reals, conds), D(fakes, conds)
    ric = D(reals, fake_conds, feats=[r[2] for r in rcc])
    cond = (_mean([bce_one(r[1] - f[1]) for r, f in zip(rcc, fcc)])
            + _mean([bce_one(r[1] - m[1]) for r, m in zip(rcc, ric)])) / 2
    uncond = _mean([bce_one(r[0] - f[0]) for r, f in zip(rcc, fcc)])
    return (uncond + cond) / 2


def gradient_penalty(D, alphas, reals, fakes, conds, fake_conds):
    total = 0.0
    with in_gradient_penalty():
        for i, (r, f, c, fc) in enumerate(zip(reals, fakes, conds, fake_conds)):
            a = alphas[i][: r.shape[0]]
            ix = (a.reshape((-1,) + (1,) * (r.dim() - 1)) * r
                  + (1 - a.reshape((-1,) + (1,) * (r.dim() - 1))) * f).detach()
            ix.requires_grad_(True)
            ac = a[:, None]
            u, cl, _ = D.discrim(ix, ac * c + (1 - ac) * fc)
            (g,) = torch.autograd.grad(u.sum() + cl.sum(), ix, create_graph=True)
            norms = torch.sqrt((g.flatten(1) ** 2).sum(1) + 1e-12)
            total = total + (norms ** 2).sum()
    return total


class Adam:
    def __init__(self, params, lr, b1, b2, eps=1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def clip(grads, limit):
    """(global norm, grads scaled so the norm is at most `limit`; limit 0:
    no clip)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    if not limit:
        return norm, grads
    scale = torch.where(torch.isfinite(norm),
                        torch.clamp(limit / torch.clamp(norm, min=1e-20), max=1.0),
                        torch.zeros_like(norm))
    return norm, [g * scale for g in grads]


class ReferenceTrainer:
    """The configuration's G, D and frozen encoder with their optimizers and
    the generator's EMA; `step` runs one train step."""

    def __init__(self, spec: dict, vocab_size: int, weights: dict, device, remat=None,
                 dtype=torch.float32):
        from portbench.weights import load, part
        self.spec, self.train = spec, spec["train"]
        self.G, self.D, self.E = (m.to(dtype) for m in build(spec, vocab_size, device, remat))
        if weights is not None:
            for name, module in (("G", self.G), ("D", self.D), ("E", self.E)):
                load(module, part(weights, name))
        self.G.train()
        self.D.train()
        t = self.train
        self.g_params = list(self.G.parameters())
        self.d_params = list(self.D.parameters())
        self.opt_g = Adam(self.g_params, t["G_lr"], t["G_beta1"], t["G_beta2"])
        self.opt_d = Adam(self.d_params, t["D_lr"], t["D_beta1"], t["D_beta2"])
        decay = t.get("g_ema") or 0.0
        self.ema_decay = decay
        self.ema = {n: p.detach().clone() for n, p in self.G.named_parameters()} if decay else None
        self.step_index = 0

    def draws(self, seed: int, batch: int) -> dict:
        t = self.train
        return draws(seed, self.step_index, batch, self.G.latent_size, len(t["frame_sizes"]),
                     t["subsample_input"], self.G.num_blocks, t["gp_lambda"] > 0)

    def step(self, video_u8, ids, lengths, dr: dict) -> dict:
        """One step; returns loss_d, loss_g and the clipped gradients the
        optimizers took (`grad_d`, `grad_g`, in parameter order)."""
        t = self.train
        device = video_u8.device
        x = video_u8.to(self.g_params[0].dtype) / 127.5 - 1.0
        with torch.no_grad():
            cond = self.E(ids.to(device), lengths.to(device))
        reals, conds = pyramid(x, cond, t["frame_sizes"], dr["pyramid"], t["subsample_input"])
        perm = dr["perm"].to(device)
        fake_conds = [cond[perm][: c.shape[0]] for c in conds]
        fakes = self.G(dr["z"].to(device, x.dtype), cond, phases=dr["phases"])
        fixed = [f.detach() for f in fakes]

        loss_d = discrim_loss(self.D, reals, fixed, conds, fake_conds)
        gp_on = t["gp_lambda"] > 0 and self.step_index % t["gp_every"] == 0
        if gp_on:
            alphas = [a.to(device, x.dtype) for a in dr["alphas"]]
            loss_d = loss_d + t["gp_lambda"] * t["gp_every"] * gradient_penalty(
                self.D, alphas, reals, fixed, conds, fake_conds)
        grad_d = torch.autograd.grad(loss_d, self.d_params, allow_unused=True)
        grad_d = [torch.zeros_like(p) if g is None else g for p, g in zip(self.d_params, grad_d)]
        norm_d, grad_d = clip(grad_d, t.get("clip_grad") or 0.0)
        self.opt_d.step(grad_d)

        with torch.no_grad():
            preds = self.D(reals, conds)
        fcc = self.D(fakes, conds)
        loss_g = (_mean([bce_one(f[1] - p[1]) for f, p in zip(fcc, preds)])
                  + _mean([bce_one(f[0] - p[0]) for f, p in zip(fcc, preds)])) / 2
        grad_g = torch.autograd.grad(loss_g, self.g_params, allow_unused=True)
        grad_g = [torch.zeros_like(p) if g is None else g for p, g in zip(self.g_params, grad_g)]
        norm_g, grad_g = clip(grad_g, t.get("clip_grad") or 0.0)
        self.opt_g.step(grad_g)
        if self.ema is not None:
            with torch.no_grad():
                for n, p in self.G.named_parameters():
                    self.ema[n].lerp_(p, 1 - self.ema_decay)
        self.step_index += 1
        return {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(), "grad_d": grad_d,
                "grad_g": grad_g, "grad_norm_d": norm_d, "grad_norm_g": norm_g}
