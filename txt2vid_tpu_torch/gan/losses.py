"""GAN loss zoo and gradient penalty (counterpart of
txt2vid_tpu/gan/losses.py:27-197).

Every loss exposes `discrim_loss(fake=..., real=...)` and
`gen_loss(fake=..., real=...)` over raw logits, with the JAX package's
semantics: real = 1 / fake = 0 for the vanilla loss, the reference's effective
hinge math, and the RaSGAN typo fixed. Losses are float32.

The gradient penalties take their interpolation weights alpha from the
caller (one per batch element): JAX's jax.random.uniform stream cannot be
reproduced in torch, so a test pins alpha on both sides.

Every batch mean goes through `_mean` and the relativistic losses' inner
mean(fake) / mean(real) through `_shared_mean`: in a train step whose batch
is split over data-parallel ranks (ops/batch_group.py) the first is this
rank's share of the global mean (its partial sum over the global count; the
ranks' gradients sum to the global one) and the second the global mean on
every rank, its gradient reaching every rank's items.
"""

import torch
import torch.nn.functional as F

from txt2vid_tpu_torch.ops import batch_group


def _mean(x):
    group = batch_group.group()
    return x.mean() if group is None else group.mean(x)


def _shared_mean(x):
    group = batch_group.group()
    return x.mean() if group is None else group.shared_mean(x)


def _bce_logits(logits, labels):
    if batch_group.group() is None:
        return F.binary_cross_entropy_with_logits(logits.float(), labels)
    return _mean(F.binary_cross_entropy_with_logits(logits.float(), labels, reduction="none"))


class MixedGanLoss:
    """Separate G and D losses."""

    def __init__(self, g_loss=None, d_loss=None):
        self.g_loss = g_loss
        self.d_loss = d_loss

    def discrim_loss(self, fake=None, real=None):
        return self.d_loss.discrim_loss(fake=fake, real=real)

    def gen_loss(self, fake=None, real=None):
        return self.g_loss.gen_loss(fake=fake, real=real)


class VanillaGanLoss:
    """Non-saturating BCE GAN loss, real = 1 / fake = 0."""

    def __init__(self, bce_loss=True, reduction="mean"):
        if not bce_loss:
            raise ValueError("only the BCE form exists (binary logits)")

    def discrim_loss(self, fake=None, real=None):
        return (_bce_logits(fake, torch.zeros_like(fake, dtype=torch.float32))
                + _bce_logits(real, torch.ones_like(real, dtype=torch.float32)))

    def gen_loss(self, fake=None, real=None):
        return _bce_logits(fake, torch.ones_like(fake, dtype=torch.float32))


class HingeGanLoss:
    """D: mean(relu(margin - real)) + mean(fake); G: mean(relu(margin - fake))."""

    def __init__(self, margin=2.0):
        self.margin = margin

    def discrim_loss(self, fake=None, real=None):
        return _mean(torch.relu(self.margin - real.float())) + _mean(fake.float())

    def gen_loss(self, fake=None, real=None):
        return _mean(torch.relu(self.margin - fake.float()))


class WassersteinGanLoss:
    """WGAN critic losses."""

    def discrim_loss(self, fake=None, real=None):
        return -(_mean(real.float()) - _mean(fake.float()))

    def gen_loss(self, fake=None, real=None):
        return -_mean(fake.float())


class RSGANLoss:
    """Relativistic standard GAN: D BCE(real - fake, 1); G BCE(fake - real, 1)."""

    def __init__(self, bce_loss=True):
        if not bce_loss:
            raise ValueError("only the BCE form exists (binary logits)")

    def discrim_loss(self, fake=None, real=None):
        d = real - fake
        return _bce_logits(d, torch.ones_like(d, dtype=torch.float32))

    def gen_loss(self, fake=None, real=None):
        d = fake - real
        return _bce_logits(d, torch.ones_like(d, dtype=torch.float32))


class RaSGANLoss:
    """Relativistic average GAN."""

    def __init__(self, bce_loss=True):
        if not bce_loss:
            raise ValueError("only the BCE form exists (binary logits)")

    def discrim_loss(self, fake=None, real=None):
        a = real - _shared_mean(fake)
        b = fake - _shared_mean(real)
        return (_bce_logits(a, torch.ones_like(a, dtype=torch.float32))
                + _bce_logits(b, torch.zeros_like(b, dtype=torch.float32))) / 2

    def gen_loss(self, fake=None, real=None):
        a = real - _shared_mean(fake)
        b = fake - _shared_mean(real)
        return (_bce_logits(a, torch.zeros_like(a, dtype=torch.float32))
                + _bce_logits(b, torch.ones_like(b, dtype=torch.float32))) / 2


class RaLSGANLoss:
    """Relativistic average least-squares GAN."""

    def discrim_loss(self, fake=None, real=None):
        fake, real = fake.float(), real.float()
        return (_mean((real - _shared_mean(fake) - 1.0) ** 2)
                + _mean((fake - _shared_mean(real) + 1.0) ** 2)) / 2

    def gen_loss(self, fake=None, real=None):
        fake, real = fake.float(), real.float()
        return (_mean((real - _shared_mean(fake) + 1.0) ** 2)
                + _mean((fake - _shared_mean(real) - 1.0) ** 2)) / 2


# ---------------------------------------------------------------------------
# Gradient penalty (losses.py:132-197)
# ---------------------------------------------------------------------------

def _interpolate(alpha, real, fake):
    return alpha * real + (1.0 - alpha) * fake


def gradient_penalty(d_fn, alpha, real_x, fake_x, real_cond=None, fake_cond=None,
                     zero_center: bool = False, combine: str = "mean", real_xbar=None,
                     fake_xbar=None):
    """WGAN-GP on alpha-interpolated inputs (losses.py:136-174).

    d_fn(x, cond) -> (uncond_logit | None, cond_logit | None), or, with the
    sample mapping's real_xbar and fake_xbar, d_fn(x, cond, xbar); alpha:
    (B,) in [0, 1), shared by x, cond and xbar. The norm is of the gradient
    of the summed logits w.r.t. the interpolated x only, taken with
    create_graph=True so the penalty can be differentiated w.r.t. D's
    parameters; float32, per sample sqrt(sum g^2 + 1e-12). A discriminator
    that does not read x (the TCWYT frame and motion heads read xbar alone)
    has a zero gradient there, as jax.grad gives: each norm is then
    sqrt(1e-12). zero_center: ||g||^2 (R1-style) instead of (||g|| - 1)^2;
    combine: "mean" or "sum" over the batch."""
    b = real_x.shape[0]

    def mix(real, fake):
        if real is None or fake is None:
            return None
        a = alpha.reshape((b,) + (1,) * (real.ndim - 1)).to(real.dtype)
        return _interpolate(a, real, fake)

    ix = mix(real_x.detach(), fake_x.detach()).requires_grad_(True)
    icond, ixbar = mix(real_cond, fake_cond), mix(real_xbar, fake_xbar)
    uncond, cond_out = d_fn(ix, icond) if ixbar is None else d_fn(ix, icond, ixbar)
    total = sum(t.sum() for t in (uncond, cond_out) if t is not None)
    (grads,) = torch.autograd.grad(total, ix, create_graph=True, allow_unused=True)
    grads = torch.zeros_like(ix, dtype=torch.float32) if grads is None else grads.float()
    norms = torch.sqrt(torch.sum(grads.flatten(1) ** 2, dim=1) + 1e-12)
    per_sample = norms ** 2 if zero_center else (norms - 1.0) ** 2
    return per_sample.sum() if combine == "sum" else _mean(per_sample)


def multiscale_gradient_penalty(d_fn_for_scale, alphas, real_xs, fake_xs,
                                real_conds=None, fake_conds=None):
    """Per-scale zero-centred sum-combined GP, summed over scales
    (losses.py:177-197). d_fn_for_scale(i) -> the d_fn of scale i; alphas[i]
    holds at least scale i's batch of weights (the first B_i are used)."""
    total = 0.0
    for i in range(len(real_xs)):
        total = total + gradient_penalty(
            d_fn_for_scale(i), alphas[i][: real_xs[i].shape[0]],
            real_x=real_xs[i], fake_x=fake_xs[i],
            real_cond=None if real_conds is None else real_conds[i],
            fake_cond=None if fake_conds is None else fake_conds[i],
            zero_center=True, combine="sum")
    return total
