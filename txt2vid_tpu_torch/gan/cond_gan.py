"""Conditional GAN facade (counterpart of txt2vid_tpu/gan/cond_gan.py:38-309):
holds the generator, the discriminators and the caption encoder, and
assembles the losses.

Pairwise conditional D loss: real_cc = D(x_r, c_r), real_ic = D(x_r, c_f)
(reusing real_cc's features), fake_cc = D(x_f, c_r); D loss = (mean
unconditional pairing + mean of the two conditional pairings) / 2. The G loss
re-forwards D on the fakes against cached real predictions. Mismatched
captions are a derangement of the scale-0 cond, truncated per scale.
Discriminators are MultiScaleDiscrims, whose output is a list of per-scale
triples (uncond, cond | None, features).

With gp_lambda > 0 each discriminator's loss gains gp_lambda times its
multiscale gradient penalty, evaluated per scale through `scale_indices=[si]`
on alpha-interpolated inputs (cond_gan.py:142-149, 190-235). The penalty's
forward and its create_graph gradient run under no_kernel(), as the JAX
package runs them under no_pallas(): FusedAttention has no second-order
gradient and raises on one. gp_only returns the weighted penalty alone; it
shares no intermediates with the main loss, so main + gp_only is the loss
with both terms, and so are their parameter gradients.
"""

import torch

from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.convert import (jax_to_torch_discriminator, jax_to_torch_generator,
                                       load_encoder_vars, torch_to_jax_discriminator,
                                       torch_to_jax_encoder, torch_to_jax_generator)
from txt2vid_tpu_torch.data import load_pickle
from txt2vid_tpu_torch.gan.ema import init_ema, load_ema
from txt2vid_tpu_torch.gan.losses import multiscale_gradient_penalty
from txt2vid_tpu_torch.ops.attention import no_kernel
from txt2vid_tpu_torch.utils.checkpoint import restore_state


class CondGan:
    def __init__(self, gen, cond_encoder=None, discrims=None, discrim_lambdas=None):
        self.gen = gen
        self.cond_encoder = cond_encoder
        self.discrims = list(discrims or [])
        self.discrim_lambdas = discrim_lambdas

    def generate(self, z, cond=None, train: bool = False, phases=None, generator=None):
        """Run the generator; returns a LIST of scales (B, T, H, W, C). In
        training the subsample phases come from `phases` or `generator`."""
        if not train:
            return self.gen(z, cond=cond, train=False)
        return self.gen(z, cond=cond, train=True, phases=phases, generator=generator)

    def encode(self, captions, lengths):
        """Caption encoding -> (B, cond_dim) sentence vectors (hn)."""
        return self.cond_encoder.encode(captions, lengths)[2]

    def apply_discrim(self, i, x_scales, cond_scales=None, computed_features=None):
        """Apply discriminator i (a MultiScaleDiscrim: the port has no
        single-scale discriminator yet); returns its per-scale triples."""
        return self.discrims[i](x_scales, cond=cond_scales,
                                computed_features=computed_features)

    @staticmethod
    def make_fake_conds(cond_scales, perm):
        """Mismatched captions: the scale-0 cond permuted by the derangement
        `perm` (utils.misc.gen_perm_device), truncated to each scale's batch."""
        fake0 = cond_scales[0][perm.to(cond_scales[0].device)]
        return [fake0[: c.shape[0]] for c in cond_scales]

    def discrim_forward(self, i, real_scales=None, fake_scales=None, cond_scales=None,
                        fake_cond_scales=None, loss=None, gp_lambda: float = -1.0,
                        alphas=None, gp_only: bool = False):
        """Per-discriminator D-phase loss. Returns (loss | None, fake_pred, real_pred).
        alphas: the GP's interpolation weights per scale (needed with
        gp_lambda > 0)."""
        l = fake_pred = real_pred = None
        if gp_only:
            if loss is not None and gp_lambda > 0:
                l = gp_lambda * self.gradient_penalty(i, alphas, real_scales, fake_scales,
                                                      cond_scales, fake_cond_scales)
            return l, fake_pred, real_pred
        if cond_scales is not None:
            real_cc = self.apply_discrim(i, real_scales, cond_scales)
            real_pred = real_cc
            if loss is not None:
                if fake_cond_scales is None:
                    raise ValueError("a conditional D loss needs fake_cond_scales")
                real_ic = self.apply_discrim(i, real_scales, fake_cond_scales,
                                             computed_features=[t[2] for t in real_cc])
                fake_cc = self.apply_discrim(i, fake_scales, cond_scales)
                fake_pred = fake_cc
                loss_c1 = torch.stack([loss.discrim_loss(fake=f[1], real=r[1])
                                       for f, r in zip(fake_cc, real_cc)])
                loss_c2 = torch.stack([loss.discrim_loss(fake=f[1], real=r[1])
                                       for f, r in zip(real_ic, real_cc)])
                loss_cond = (loss_c1.mean() + loss_c2.mean()) / 2.0
                loss_uncond = torch.stack([loss.discrim_loss(fake=f[0], real=r[0])
                                           for f, r in zip(fake_cc, real_cc)]).mean()
                l = (loss_uncond + loss_cond) / 2.0
        else:
            if real_scales is not None:
                real_pred = self.apply_discrim(i, real_scales)
            if fake_scales is not None:
                fake_pred = self.apply_discrim(i, fake_scales)
            if loss is not None and fake_pred is not None and real_pred is not None:
                l = torch.stack([loss.discrim_loss(fake=f[0], real=r[0])
                                 for f, r in zip(fake_pred, real_pred)]).mean()
        if l is not None and gp_lambda > 0:
            l = l + gp_lambda * self.gradient_penalty(i, alphas, real_scales, fake_scales,
                                                      cond_scales, fake_cond_scales)
        return l, fake_pred, real_pred

    def gradient_penalty(self, i, alphas, real_scales, fake_scales, cond_scales=None,
                         fake_cond_scales=None):
        """Discriminator i's multiscale GP (cond_gan.py:198-222), under no_kernel()."""
        d = self.discrims[i]

        def d_fn_for_scale(si):
            def fn(x, cond):
                u, c, _ = d([x], cond=None if cond is None else [cond],
                            scale_indices=[si])[0]
                return u, c
            return fn

        with no_kernel():
            return multiscale_gradient_penalty(
                d_fn_for_scale, alphas, real_scales, fake_scales,
                real_conds=cond_scales, fake_conds=fake_cond_scales)

    def all_discrim_forward(self, real_scales=None, fake_scales=None, cond_scales=None,
                            loss=None, perms=None, gp_lambda: float = -1.0,
                            alphas=None, gp_only: bool = False):
        """Loop over discriminators; perms[i] is discriminator i's derangement
        (needed with conds and a loss), alphas[i] its GP weights per scale
        (needed with gp_lambda > 0). Returns (losses, fake_preds, real_preds)."""
        losses, fake_preds, real_preds = [], [], []
        for i in range(len(self.discrims)):
            fake_conds = None
            if cond_scales is not None and loss is not None:
                fake_conds = self.make_fake_conds(cond_scales, perms[i])
            l, f, r = self.discrim_forward(
                i, real_scales=real_scales, fake_scales=fake_scales,
                cond_scales=cond_scales, fake_cond_scales=fake_conds, loss=loss,
                gp_lambda=gp_lambda, alphas=None if alphas is None else alphas[i],
                gp_only=gp_only)
            losses.append(l)
            fake_preds.append(f)
            real_preds.append(r)
        return losses, fake_preds, real_preds

    def weighted_sum(self, losses):
        """Mean or lambda-weighted sum over per-discriminator losses."""
        stacked = torch.stack(losses)
        if self.discrim_lambdas is None:
            return stacked.mean()
        lambdas = torch.as_tensor(self.discrim_lambdas, dtype=stacked.dtype,
                                  device=stacked.device)
        return (lambdas * stacked).sum()

    def gen_loss(self, fake_scales, real_preds, cond_scales=None, loss=None):
        """G-phase loss against cached real predictions."""
        losses = []
        for i in range(len(self.discrims)):
            fake_cc = self.apply_discrim(i, fake_scales, cond_scales)
            r = real_preds[i]
            if cond_scales is None:
                losses.append(torch.stack([loss.gen_loss(fake=f[0], real=rr[0])
                                           for f, rr in zip(fake_cc, r)]).mean())
                continue
            loss_cond = torch.stack([loss.gen_loss(fake=f[1], real=rr[1])
                                     for f, rr in zip(fake_cc, r)]).mean()
            loss_uncond = torch.stack([loss.gen_loss(fake=f[0], real=rr[0])
                                       for f, rr in zip(fake_cc, r)]).mean()
            losses.append((loss_cond + loss_uncond) / 2.0)
        return self.weighted_sum(losses)


def load_checkpoint_gan(weights, G, D, sent=None, vocab_path=None,
                        frame_sizes=(8, 16, 32, 64), num_frames=16, num_channels=3,
                        bf16: bool = False, ema: bool = False):
    """(CondGan, vocab) from a training checkpoint (the whole train state,
    flax msgpack) and the specs it was trained with: G, the list D and the
    caption encoder `sent` (built when a vocabulary is given), on the CPU.
    The generator, its BatchNorm statistics, the discriminators and the
    encoder come from the file; with `ema` the generator takes the
    parameters of the `<weights>.ema` sibling. frame_sizes, num_frames and
    num_channels describe the training batch and must agree with the
    generator. `bf16` computes the generator in bfloat16 from the float32
    checkpoint."""
    vocab = load_pickle(vocab_path) if vocab_path else None
    txt, cond_dim = None, 0
    if vocab is not None:
        txt = create_object(sent or "txt2vid_tpu_torch.models.txt.Seq2Seq",
                            vocab_size=len(vocab))
        cond_dim = txt.encoding_size
    gen = create_object(G, cond_dim=cond_dim, **({"dtype": torch.bfloat16} if bf16 else {}))
    discrims = [create_object(d, cond_dim=cond_dim) for d in D]
    size = gen.fm_w * 8 * 2 ** (gen.num_blocks - 1)
    rendered = (gen.num_frames, size, gen.render_base.conv.out_channels)
    if rendered != (num_frames, frame_sizes[-1], num_channels):
        raise ValueError(f"the generator renders (frames, size, channels) {rendered}, "
                         f"not {(num_frames, frame_sizes[-1], num_channels)}")

    g_params, g_stats = torch_to_jax_generator(gen.state_dict())
    template = {"g_vars": {"batch_stats": g_stats, "params": g_params},
                "d_vars": {str(k): {"params": torch_to_jax_discriminator(d.state_dict())}
                           for k, d in enumerate(discrims)}}
    if txt is not None:
        template["txt_vars"] = {"params": torch_to_jax_encoder(txt.state_dict(),
                                                               decoder=False)}
    state = restore_state(template, weights)
    with torch.no_grad():
        gen.load_state_dict(jax_to_torch_generator(state["g_vars"]["params"],
                                                   state["g_vars"]["batch_stats"]))
        for k, d in enumerate(discrims):
            d.load_state_dict(jax_to_torch_discriminator(state["d_vars"][str(k)]["params"]))
        if txt is not None:
            load_encoder_vars(txt, state["txt_vars"])
        if ema:
            params = load_ema(weights, init_ema(gen))
            if params is None:
                raise FileNotFoundError(f"ema=True: no sibling {weights}.ema (a run "
                                        "trained without --g_ema?)")
            for n, p in gen.named_parameters():
                p.copy_(params[n])
    return CondGan(gen, txt, discrims=discrims), vocab
