"""GAN loss zoo (counterpart of txt2vid_tpu/gan/losses.py:27-125).

Every loss exposes `discrim_loss(fake=..., real=...)` and
`gen_loss(fake=..., real=...)` over raw logits, with the JAX package's
semantics: real = 1 / fake = 0 for the vanilla loss, the reference's effective
hinge math, and the RaSGAN typo fixed. Losses are float32. The gradient
penalty comes in a later slice.
"""

import torch
import torch.nn.functional as F


def _bce_logits(logits, labels):
    return F.binary_cross_entropy_with_logits(logits.float(), labels)


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
        return torch.relu(self.margin - real.float()).mean() + fake.float().mean()

    def gen_loss(self, fake=None, real=None):
        return torch.relu(self.margin - fake.float()).mean()


class WassersteinGanLoss:
    """WGAN critic losses."""

    def discrim_loss(self, fake=None, real=None):
        return -(real.float().mean() - fake.float().mean())

    def gen_loss(self, fake=None, real=None):
        return -fake.float().mean()


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
        a = real - fake.mean()
        b = fake - real.mean()
        return (_bce_logits(a, torch.ones_like(a, dtype=torch.float32))
                + _bce_logits(b, torch.zeros_like(b, dtype=torch.float32))) / 2

    def gen_loss(self, fake=None, real=None):
        a = real - fake.mean()
        b = fake - real.mean()
        return (_bce_logits(a, torch.zeros_like(a, dtype=torch.float32))
                + _bce_logits(b, torch.ones_like(b, dtype=torch.float32))) / 2


class RaLSGANLoss:
    """Relativistic average least-squares GAN."""

    def discrim_loss(self, fake=None, real=None):
        fake, real = fake.float(), real.float()
        return (((real - fake.mean() - 1.0) ** 2).mean()
                + ((fake - real.mean() + 1.0) ** 2).mean()) / 2

    def gen_loss(self, fake=None, real=None):
        fake, real = fake.float(), real.float()
        return (((real - fake.mean() + 1.0) ** 2).mean()
                + ((fake - real.mean() - 1.0) ** 2).mean()) / 2
