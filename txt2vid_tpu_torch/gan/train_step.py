"""The GAN train step (counterpart of txt2vid_tpu/gan/train_step.py:281-578,
`build_train_step`).

One step: the frozen caption encoding, the real pyramid, one generator
forward whose fakes, detached, feed the D phase, the D update, the real
predictions of the updated D without gradient, and the G update through the
updated D, pulled back through the same generator forward. The generator's
BatchNorm running statistics are updated once per step. Modules and
optimizers are updated in place.

This slice implements frame_sizes, subsample_input, latent_size,
mean_discrim_loss, mean_gen_loss and shared_gen_fwd, with discrim_steps ==
gen_steps == 1; any other field away from its default raises
NotImplementedError naming it. The step runs one generator forward for either
value of shared_gen_fwd: outside end2end, which is refused, JAX's two-forward
form computes the same numbers (its D-phase forward discards its BatchNorm
statistics), so the flag changes nothing here.
"""

from dataclasses import dataclass, fields
from typing import Any, Sequence

import numpy as np
import torch

from txt2vid_tpu_torch.ops.subsample import multiscale_pyramid
from txt2vid_tpu_torch.utils.misc import gen_perm_device


@dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig fields and defaults (train_step.py:31-110)."""

    frame_sizes: Sequence[int] = (64,)
    subsample_input: bool = False
    discrim_steps: int = 1
    gen_steps: int = 1
    gp_lambda: float = -1.0
    gp_every: int = 1
    gp_quarantine: bool = False
    end2end: bool = False
    end2end_txt_in_g: bool = True
    mean_discrim_loss: bool = False
    mean_gen_loss: bool = False
    img_model: bool = False
    latent_size: int = 256
    clip_grad: float = 0.0
    shared_gen_fwd: bool = False
    compute_dtype: Any = None


_IMPLEMENTED = {"frame_sizes", "subsample_input", "latent_size", "mean_discrim_loss",
                "mean_gen_loss", "shared_gen_fwd", "discrim_steps", "gen_steps",
                # only read with end2end, which is refused below
                "end2end_txt_in_g"}


def check_config(config: TrainConfig):
    """Raise NotImplementedError for each field this slice does not implement."""
    defaults = TrainConfig()
    for f in fields(TrainConfig):
        if f.name not in _IMPLEMENTED and getattr(config, f.name) != getattr(defaults, f.name):
            raise NotImplementedError(
                f"TrainConfig.{f.name}={getattr(config, f.name)!r} comes in a later "
                "slice of the port")
    if config.discrim_steps != 1 or config.gen_steps != 1:
        raise NotImplementedError("discrim_steps and gen_steps other than 1 come in "
                                  "a later slice of the port")


@dataclass
class Draws:
    """The random numbers of one step: z (B, latent_size), the temporal phases
    of the real pyramid and of the generator's subsamples, and one caption
    derangement per discriminator."""

    z: torch.Tensor
    pyramid_phases: Sequence[int]
    gen_phases: Sequence[int]
    perms: Sequence[torch.Tensor]


def adam(params, lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999):
    """torch's Adam with optax.adam's update (eps 1e-8 added to the bias-corrected
    root of the second moment), float32 moments."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainStep:
    """`step(batch, draws=None) -> metrics`. batch: "video" (B, T, H, W, C) float
    in [-1, 1] or uint8, and with a caption encoder "captions" (B, L) int and
    "lengths" (B,) on the host. Without `draws` they come from a CPU
    torch.Generator seeded from (seed, step). Metrics are device scalars:
    loss_d, loss_g, grad_norm_d, grad_norm_g (pre-update global norms)."""

    def __init__(self, gan, losses, opt_g, opt_d, config: TrainConfig, seed: int = 0):
        check_config(config)
        self.gan = gan
        self.losses = losses
        self.opt_g = opt_g
        self.opt_d = opt_d
        self.config = config
        self.seed = seed
        self.step = 0

    def draw(self, batch_size: int, device) -> Draws:
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence([self.seed, self.step])
                            .generate_state(1)[0]))
        cfg = self.config
        z = torch.randn(batch_size, cfg.latent_size, generator=gen)
        n_pyr = len(cfg.frame_sizes) - 1 if cfg.subsample_input else 0
        pyramid = [int(torch.randint(0, 2, (), generator=gen)) for _ in range(n_pyr)]
        gen_phases = [int(torch.randint(0, 2, (), generator=gen))
                      for _ in range(self.gan.gen.num_blocks - 1)]
        perms = [gen_perm_device(batch_size, generator=gen).to(device)
                 for _ in self.gan.discrims]
        return Draws(z.to(device), pyramid, gen_phases, perms)

    def __call__(self, batch, draws: Draws | None = None):
        gan, cfg, losses = self.gan, self.config, self.losses
        x = batch["video"]
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        if draws is None:
            draws = self.draw(x.shape[0], x.device)

        cond = None
        if gan.cond_encoder is not None and batch.get("captions") is not None:
            with torch.no_grad():
                cond = gan.encode(batch["captions"], batch["lengths"])
        real_scales, cond_scales = multiscale_pyramid(
            x, cond, list(cfg.frame_sizes), draws.pyramid_phases, cfg.subsample_input)

        gan.gen.train()
        fakes_live = gan.generate(draws.z, cond=cond, train=True, phases=draws.gen_phases)
        fakes = [f.detach() for f in fakes_live]
        if [f.shape[2:4] for f in fakes] != [r.shape[2:4] for r in real_scales]:
            raise ValueError(
                f"generator pyramid {[tuple(f.shape[2:4]) for f in fakes]} does not "
                f"match the frame_sizes pyramid "
                f"{[tuple(r.shape[2:4]) for r in real_scales]}")

        # D phase: fakes detached, so the backward reaches only D's parameters
        d_params = [p for d in gan.discrims for p in d.parameters()]
        self.opt_d.zero_grad(set_to_none=True)
        ls, _, _ = gan.all_discrim_forward(real_scales, fakes, cond_scales, loss=losses,
                                           perms=draws.perms)
        loss_d = gan.weighted_sum(ls)
        if cfg.mean_discrim_loss:
            loss_d = loss_d / cfg.discrim_steps
        loss_d.backward()
        grad_norm_d = global_norm([p.grad for p in d_params if p.grad is not None])
        self.opt_d.step()

        # G phase, through the updated D; its real predictions carry no gradient
        with torch.no_grad():
            real_preds = gan.all_discrim_forward(real_scales, cond_scales=cond_scales)[2]
        g_params = list(gan.gen.parameters())
        self.opt_g.zero_grad(set_to_none=True)
        # the gradient w.r.t. the kept fakes, pulled back through the one
        # generator forward; autograd.grad leaves D's parameters alone
        leaves = [f.detach().requires_grad_() for f in fakes_live]
        loss_g = gan.gen_loss(leaves, real_preds, cond_scales, loss=losses)
        if cfg.mean_gen_loss:
            loss_g = loss_g / cfg.gen_steps
        dfakes = torch.autograd.grad(loss_g, leaves)
        torch.autograd.backward(fakes_live, dfakes)
        grad_norm_g = global_norm([p.grad for p in g_params if p.grad is not None])
        self.opt_g.step()

        self.step += 1
        return {"loss_d": loss_d.detach(), "loss_g": loss_g.detach(),
                "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g}


def build_train_step(gan, losses, opt_g, opt_d, config: TrainConfig,
                     seed: int = 0) -> TrainStep:
    """The port's counterpart of build_train_step: a TrainStep over `gan`
    (generator, discriminators, optional frozen caption encoder) and the two
    optimizers (see `adam`)."""
    return TrainStep(gan, losses, opt_g, opt_d, config, seed)
