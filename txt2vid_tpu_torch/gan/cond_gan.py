"""Conditional GAN facade (counterpart of txt2vid_tpu/gan/cond_gan.py:38-309):
holds the generator, the discriminators, the caption encoder and the
sample mapping M, and assembles the losses.

Pairwise conditional D loss: real_cc = D(x_r, c_r), real_ic = D(x_r, c_f)
(reusing real_cc's features), fake_cc = D(x_f, c_r); D loss = (mean
unconditional pairing + mean of the two conditional pairings) / 2, or the
conditional pairings alone where the discriminator gives no unconditional
logit. The G loss re-forwards D on the fakes against cached real
predictions. Mismatched captions are a derangement of the scale-0 cond,
truncated per scale.

Every discriminator's output is normalised to a list of per-scale triples
(uncond | None, cond | None, features | None) (`normalize_preds`): a
MultiScaleDiscrim gives them; a single-scale discriminator (the TCWYT and
image families) gives one logit tensor, which is the conditional logit when
a caption is given and the unconditional one otherwise. A single-scale
discriminator sees the scale-0 video as x, the scale-0 cond, and `xbar`,
the sample mapping's features of that video.

M (`sample_mapping`, the TCWYT FrameMap of --M) is a frozen feature
extractor: in neither optimizer, its parameters never move (requires_grad is
off). The D phase maps the reals and the detached fakes; the G loss maps
the fakes it is given, and G's gradient flows back through M. Every
discriminator and M forward runs under layers.frozen_batch_stats(): the JAX
package applies them with mutable batch statistics and discards the
update, so their running statistics keep their init values while their
train-mode forwards normalise with the batch's statistics.

With gp_lambda > 0 each discriminator's loss gains gp_lambda times its
gradient penalty on alpha-interpolated inputs (cond_gan.py:142-149,
190-235): a MultiScaleDiscrim's per scale through `scale_indices=[si]`
(zero-centred, summed); a single-scale one's on the scale-0 x, cond and
xbar interpolated with the same alpha ((||g|| - 1)^2, averaged), the
gradient taken w.r.t. x alone. The penalty's forward and its create_graph
gradient run under no_kernel(), as the JAX package runs them under
no_pallas(): FusedAttention has no second-order gradient and raises on one.
gp_only returns the weighted penalty alone; it shares no intermediates with
the main loss, so main + gp_only is the loss with both terms, and so are
their parameter gradients.
"""

import torch

from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.convert import (load_encoder_vars, load_module_vars, module_vars,
                                       torch_to_jax_encoder)
from txt2vid_tpu_torch.data import load_pickle
from txt2vid_tpu_torch.gan.ema import init_ema, load_ema
from txt2vid_tpu_torch.gan.losses import gradient_penalty, multiscale_gradient_penalty
from txt2vid_tpu_torch.models.layers import frozen_batch_stats
from txt2vid_tpu_torch.ops.attention import no_kernel
from txt2vid_tpu_torch.utils.checkpoint import restore_state


def as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def normalize_preds(out, cond_given: bool):
    """A discriminator output -> [(uncond, cond, features), ...] per scale
    (_normalize_preds, cond_gan.py:38-45)."""
    if isinstance(out, list):
        return [t if isinstance(t, tuple) else
                ((None, t, None) if cond_given else (t, None, None)) for t in out]
    if isinstance(out, tuple) and len(out) == 3:
        return [out]
    return [(None, out, None) if cond_given else (out, None, None)]


def _mean_over_scales(loss_fn, pairs):
    return torch.stack([loss_fn(fake=f, real=r) for f, r in pairs]).mean()


class CondGan:
    def __init__(self, gen, cond_encoder=None, discrims=None, discrim_lambdas=None,
                 sample_mapping=None, discrim_names=None):
        self.gen = gen
        self.cond_encoder = cond_encoder
        self.discrims = list(discrims or [])
        self.discrim_lambdas = discrim_lambdas
        self.discrim_names = list(discrim_names or
                                  [f"discrim-{i}" for i in range(len(self.discrims))])
        self.sample_mapping = sample_mapping
        if sample_mapping is not None:
            sample_mapping.requires_grad_(False)

    def generate(self, z, cond=None, train: bool = False, phases=None, generator=None):
        """Run the generator; returns a LIST of scales (B, T, H, W, C), or of
        images (B, H, W, C) for an image generator. In training a multiscale
        generator's subsample phases come from `phases` or `generator`."""
        if not train or not hasattr(self.gen, "num_blocks"):
            return as_list(self.gen(z, cond=cond, train=train))
        return self.gen(z, cond=cond, train=True, phases=phases, generator=generator)

    def encode(self, captions, lengths):
        """Caption encoding -> (B, cond_dim) sentence vectors (hn)."""
        return self.cond_encoder.encode(captions, lengths)[2]

    def map_features(self, video):
        """The frozen sample mapping of `video` (None without M or video)."""
        if self.sample_mapping is None or video is None:
            return None
        with frozen_batch_stats():
            return self.sample_mapping(video)

    def apply_discrim(self, i, x_scales, cond_scales=None, xbar=None,
                      computed_features=None):
        """Apply discriminator i; returns its normalised per-scale triples."""
        d = self.discrims[i]
        cond_given = cond_scales is not None
        with frozen_batch_stats():
            if getattr(d, "is_multiscale", False):
                out = d(x_scales, cond=cond_scales, computed_features=computed_features)
            else:
                out = d(x=None if x_scales is None else x_scales[0],
                        cond=cond_scales[0] if cond_given else None, xbar=xbar)
        return normalize_preds(out, cond_given)

    @staticmethod
    def make_fake_conds(cond_scales, perm):
        """Mismatched captions: the scale-0 cond permuted by the derangement
        `perm` (utils.misc.gen_perm_device), truncated to each scale's batch."""
        fake0 = cond_scales[0][perm.to(cond_scales[0].device)]
        return [fake0[: c.shape[0]] for c in cond_scales]

    def discrim_forward(self, i, real_scales=None, fake_scales=None, cond_scales=None,
                        fake_cond_scales=None, real_mapping=None, fake_mapping=None,
                        loss=None, gp_lambda: float = -1.0, alphas=None,
                        gp_only: bool = False):
        """Per-discriminator D-phase loss. Returns (loss | None, fake_pred, real_pred).
        alphas: the GP's interpolation weights per scale (needed with
        gp_lambda > 0)."""
        l = fake_pred = real_pred = None

        def penalty():
            return gp_lambda * self.gradient_penalty(
                i, alphas, real_scales, fake_scales, cond_scales, fake_cond_scales,
                real_mapping, fake_mapping)

        if gp_only:
            if loss is not None and gp_lambda > 0:
                l = penalty()
            return l, fake_pred, real_pred
        if cond_scales is not None:
            real_cc = self.apply_discrim(i, real_scales, cond_scales, xbar=real_mapping)
            real_pred = real_cc
            if loss is not None:
                if fake_cond_scales is None:
                    raise ValueError("a conditional D loss needs fake_cond_scales")
                feats = [t[2] for t in real_cc]
                real_ic = self.apply_discrim(
                    i, real_scales, fake_cond_scales, xbar=real_mapping,
                    computed_features=feats if all(f is not None for f in feats) else None)
                fake_cc = self.apply_discrim(i, fake_scales, cond_scales, xbar=fake_mapping)
                fake_pred = fake_cc
                loss_cond = (_mean_over_scales(loss.discrim_loss,
                                               [(f[1], r[1]) for f, r in zip(fake_cc, real_cc)])
                             + _mean_over_scales(loss.discrim_loss,
                                                 [(f[1], r[1]) for f, r in zip(real_ic, real_cc)])
                             ) / 2.0
                if all(f[0] is not None and r[0] is not None for f, r in zip(fake_cc, real_cc)):
                    loss_uncond = _mean_over_scales(
                        loss.discrim_loss, [(f[0], r[0]) for f, r in zip(fake_cc, real_cc)])
                    l = (loss_uncond + loss_cond) / 2.0
                else:
                    l = loss_cond
        else:
            if real_scales is not None:
                real_pred = self.apply_discrim(i, real_scales, xbar=real_mapping)
            if fake_scales is not None:
                fake_pred = self.apply_discrim(i, fake_scales, xbar=fake_mapping)
            if loss is not None and fake_pred is not None and real_pred is not None:
                l = _mean_over_scales(loss.discrim_loss,
                                      [(f[0], r[0]) for f, r in zip(fake_pred, real_pred)])
        if l is not None and gp_lambda > 0:
            l = l + penalty()
        return l, fake_pred, real_pred

    def gradient_penalty(self, i, alphas, real_scales, fake_scales, cond_scales=None,
                         fake_cond_scales=None, real_mapping=None, fake_mapping=None):
        """Discriminator i's gradient penalty (cond_gan.py:198-235), under
        no_kernel(): the multiscale one for a MultiScaleDiscrim, else the
        single-scale one on scale 0 with xbar interpolated as x is."""
        d = self.discrims[i]
        if getattr(d, "is_multiscale", False):
            def d_fn_for_scale(si):
                def fn(x, cond):
                    with frozen_batch_stats():
                        u, c, _ = d([x], cond=None if cond is None else [cond],
                                    scale_indices=[si])[0]
                    return u, c
                return fn

            with no_kernel():
                return multiscale_gradient_penalty(
                    d_fn_for_scale, alphas, real_scales, fake_scales,
                    real_conds=cond_scales, fake_conds=fake_cond_scales)

        def d_fn(x, cond, xbar=None):
            u, c, _ = self.apply_discrim(i, [x], None if cond is None else [cond],
                                         xbar=xbar)[0]
            return u, c

        with no_kernel():
            return gradient_penalty(
                d_fn, alphas[0], real_scales[0], fake_scales[0],
                real_cond=None if cond_scales is None else cond_scales[0],
                fake_cond=None if fake_cond_scales is None else fake_cond_scales[0],
                real_xbar=real_mapping, fake_xbar=fake_mapping)

    def all_discrim_forward(self, real_scales=None, fake_scales=None, cond_scales=None,
                            loss=None, perms=None, gp_lambda: float = -1.0,
                            alphas=None, gp_only: bool = False, mappings=None):
        """Loop over discriminators; perms[i] is discriminator i's derangement
        (needed with conds and a loss), alphas[i] its GP weights per scale
        (needed with gp_lambda > 0). With a sample mapping the scale-0 reals
        and fakes are mapped here, without gradient (the fakes are detached
        in the D phase), unless `mappings` (real, fake) gives them. Returns
        (losses, fake_preds, real_preds)."""
        if mappings is None:
            with torch.no_grad():
                mappings = (self.map_features(None if real_scales is None else real_scales[0]),
                            self.map_features(None if fake_scales is None else fake_scales[0]))
        losses, fake_preds, real_preds = [], [], []
        for i in range(len(self.discrims)):
            fake_conds = None
            if cond_scales is not None and loss is not None:
                fake_conds = self.make_fake_conds(cond_scales, perms[i])
            l, f, r = self.discrim_forward(
                i, real_scales=real_scales, fake_scales=fake_scales,
                cond_scales=cond_scales, fake_cond_scales=fake_conds,
                real_mapping=mappings[0], fake_mapping=mappings[1], loss=loss,
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
        """G-phase loss against cached real predictions; the fakes' mapping
        carries G's gradient through M."""
        fake_mapping = self.map_features(fake_scales[0])
        losses = []
        for i in range(len(self.discrims)):
            fake_cc = self.apply_discrim(i, fake_scales, cond_scales, xbar=fake_mapping)
            r = real_preds[i]
            if cond_scales is None:
                losses.append(_mean_over_scales(loss.gen_loss,
                                                [(f[0], rr[0]) for f, rr in zip(fake_cc, r)]))
                continue
            loss_cond = _mean_over_scales(loss.gen_loss,
                                          [(f[1], rr[1]) for f, rr in zip(fake_cc, r)])
            if all(f[0] is not None and rr[0] is not None for f, rr in zip(fake_cc, r)):
                loss_uncond = _mean_over_scales(loss.gen_loss,
                                                [(f[0], rr[0]) for f, rr in zip(fake_cc, r)])
                losses.append((loss_cond + loss_uncond) / 2.0)
            else:
                losses.append(loss_cond)
        return self.weighted_sum(losses)


def load_checkpoint_gan(weights, G, D, sent=None, vocab_path=None,
                        frame_sizes=(8, 16, 32, 64), num_frames=16, num_channels=3,
                        bf16: bool = False, ema: bool = False, M=None):
    """(CondGan, vocab) from a training checkpoint (the whole train state,
    flax msgpack) and the specs it was trained with: G, the list D, the
    sample mapping M (--M; its variables are restored, as the JAX CLIs build
    it only for that) and the caption encoder `sent` (built when a vocabulary
    is given), on the CPU. The generator, its BatchNorm statistics, the
    discriminators and the encoder come from the file; with `ema` the
    generator takes the parameters of the `<weights>.ema` sibling.
    frame_sizes, num_frames and num_channels describe the training batch and
    must agree with a TGANv2 generator. `bf16` computes the generator in
    bfloat16 from the float32 checkpoint."""
    vocab = load_pickle(vocab_path) if vocab_path else None
    txt, cond_dim = None, 0
    if vocab is not None:
        txt = create_object(sent or "txt2vid_tpu_torch.models.txt.Seq2Seq",
                            vocab_size=len(vocab))
        cond_dim = txt.encoding_size
    gen = create_object(G, cond_dim=cond_dim, **({"dtype": torch.bfloat16} if bf16 else {}))
    discrims = [create_object(d, cond_dim=cond_dim) for d in D]
    mapping = create_object(M) if M else None
    if hasattr(gen, "num_blocks"):
        size = gen.fm_w * 8 * 2 ** (gen.num_blocks - 1)
        rendered = (gen.num_frames, size, gen.render_base.conv.out_channels)
        if rendered != (num_frames, frame_sizes[-1], num_channels):
            raise ValueError(f"the generator renders (frames, size, channels) {rendered}, "
                             f"not {(num_frames, frame_sizes[-1], num_channels)}")

    template = {"g_vars": module_vars(gen),
                "d_vars": {str(k): module_vars(d) for k, d in enumerate(discrims)}}
    if mapping is not None:
        template["m_vars"] = module_vars(mapping)
    if txt is not None:
        template["txt_vars"] = {"params": torch_to_jax_encoder(txt.state_dict(),
                                                               decoder=False)}
    state = restore_state(template, weights)
    with torch.no_grad():
        load_module_vars(gen, state["g_vars"])
        for k, d in enumerate(discrims):
            load_module_vars(d, state["d_vars"][str(k)])
        if mapping is not None:
            load_module_vars(mapping, state["m_vars"])
        if txt is not None:
            load_encoder_vars(txt, state["txt_vars"])
        if ema:
            params = load_ema(weights, init_ema(gen), gen)
            if params is None:
                raise FileNotFoundError(f"ema=True: no sibling {weights}.ema (a run "
                                        "trained without --g_ema?)")
            for n, p in gen.named_parameters():
                p.copy_(params[n])
    return CondGan(gen, txt, discrims=discrims, sample_mapping=mapping), vocab
