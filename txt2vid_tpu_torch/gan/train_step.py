"""The GAN train step (counterpart of txt2vid_tpu/gan/train_step.py:129-578,
`build_train_step`).

One step: the caption encoding, the real pyramid, the fakes of a generator
forward, `discrim_steps` D updates on those same fakes (detached), the real
predictions of the updated D, and `gen_steps` G updates through the updated
D. Modules and optimizers are updated in place.

The generator forward takes one of the JAX step's two forms
(train_step.py:334-367):
- shared (gen_steps 1, outside end2end): one forward, whose detached fakes
  feed the D phase and whose graph the G update pulls its gradient back
  through. JAX runs it under shared_gen_fwd; its two-forward form computes
  the same numbers there (the D-phase forward discards its BatchNorm
  statistics), so the port runs it for either value of the flag.
- two forwards (gen_steps > 1, or end2end with captions, where JAX ignores
  shared_gen_fwd): the D phase's fakes come from a forward without gradient
  whose BatchNorm statistics are dropped, and G sub-step j re-generates from
  the same z with the parameters sub-step j - 1 left, with the D phase's
  subsample phases at j = 0 and its own after (`Draws.gen_step`). Every
  sub-step's BatchNorm statistics start from the step's: they are restored
  before each sub-step and the last one's are kept, one momentum update per
  step as JAX's merge of state.g_vars makes it (:494, :551-565). loss_g sums
  the sub-steps' losses (each divided by gen_steps under mean_gen_loss),
  grad_norm_g is the last one's.

end2end (train_step.py:268-279, :373-384, :469-502, :559-563) trains the
caption encoder with the GAN: its parameters (`txt_params`, flax's tree:
every one but the LSTMs' frozen bias_ih) sit in the D optimizer and, unless
end2end_txt_in_g is off (--end2end_d_only), in the G optimizer too, each with
moments of its own. Each D step's loss re-encodes the captions with the
encoder as the previous D update left it, and the gradient penalty's
gradient reaches it through the interpolated cond; the clip's global norm
covers the encoder's gradients with the phase's. The D phase's fakes are
conditioned on the step's first encoding. The G phase starts from the
encoder the D phase left: with it in the G optimizer, each sub-step
re-encodes with gradient and re-forwards the updated D on the reals;
without, it re-encodes once without gradient. The encoder runs in training
mode (cuDNN's RNN backward needs it; it has no dropout).

The D phase carries the JAX step's regularization:
- gp_lambda > 0 adds the gradient penalty (gan/cond_gan.py) to each
  discriminator's loss; with gp_every > 1 (lazy GP) it runs only on steps
  with step % gp_every == 0, weighted gp_lambda * gp_every, and off steps
  skip it entirely;
- gp_quarantine computes the main loss's and the GP's gradients as two
  backward passes, zeroes each non-finite leaf of the GP's with torch.where
  (a multiply would turn inf * 0 into NaN) and counts the zeroed leaves, plus
  one for a non-finite GP value, as the `gp_quarantined` metric;
- clip_grad > 0 scales each phase's gradients to that global norm, reusing
  the grad-norm metric's reduction; a non-finite norm sets them to zeros (not
  None: the optimizer still steps on zeros, as optax does).

compute_dtype (--bf16_params, train_step.py:97-110,290-307) makes one copy of
every float32 parameter of G and of the discriminators in that dtype
(`param_copy`): G's once per generator forward, the discriminators' once per
D update and once for the G phase, as the JAX step casts its param trees.
Every forward and backward reads the copy; the gradients flow back through
the cast to the float32 masters, which the optimizers update. BatchNorm's
statistics and the caption encoder are not copied. Without a module dtype
the layers promote the bf16 weights back to the input's float32 (flax's
promote_dtype), so compute_dtype alone computes in float32 from weights
rounded to bf16.

The model families: a generator that renders one scale (TCWYT, TGAN, the
image GAN) draws no subsample phases; img_model (--img_model) and a single
frame size take the batch as the one scale, with no pyramid
(train_step.py:284-288); a sample mapping M (the gan's `sample_mapping`)
maps the reals and the detached fakes in the D phase and the live fakes in
the G loss (gan/cond_gan.py). Only the generator's BatchNorm statistics
change: the discriminators' and M's forwards leave theirs alone, as the JAX
step discards them.

The step counter `step` sets the draws and the lazy-GP phase; a restored
checkpoint sets it (convert.jax_state_to_torch).
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from txt2vid_tpu_torch.models.layers import frozen_batch_stats
from txt2vid_tpu_torch.ops.optim import AdamStorage
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


def check_config(config: TrainConfig):
    """Raise ValueError for step counts below 1."""
    if min(config.discrim_steps, config.gen_steps, config.gp_every) < 1:
        raise ValueError("discrim_steps, gen_steps and gp_every must be at least 1")


@dataclass
class Draws:
    """The random numbers of one step: z (B, latent_size), the temporal phases
    of the real pyramid and of the generator's subsamples, and for the first D
    step one caption derangement per discriminator and, with the gradient
    penalty, its interpolation weights per discriminator and scale (each at
    least that scale's batch long). `later_d_steps` holds (perms, alphas) of
    each further D step (discrim_steps > 1), `later_gen_phases` the
    generator's subsample phases of each further G sub-step (gen_steps > 1;
    JAX's fold_in(k_g, j))."""

    z: torch.Tensor
    pyramid_phases: Sequence[int]
    gen_phases: Sequence[int]
    perms: Sequence[torch.Tensor]
    alphas: Sequence[Sequence[torch.Tensor]] | None = None
    later_d_steps: Sequence[tuple] = ()
    later_gen_phases: Sequence[Sequence[int]] = ()

    def d_step(self, j: int):
        """(perms, alphas) of D step j."""
        return (self.perms, self.alphas) if j == 0 else self.later_d_steps[j - 1]

    def gen_step(self, j: int):
        """The generator's subsample phases of G sub-step j: the D phase's
        fakes' at j = 0 (JAX's k_gen)."""
        return self.gen_phases if j == 0 else self.later_gen_phases[j - 1]


def sgd(params, lr: float = 1e-3, momentum: float = 0.5):
    """optax.sgd(lr, momentum): the trace t <- g + momentum * t (t = g on the
    first step, as torch's buffer starts) and p <- p - lr * t, in float32."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=False)


def txt_params(gan, config: TrainConfig) -> list:
    """The caption encoder's parameters the optimizers train under end2end
    (models.txt.trainable: flax's tree), else none."""
    from txt2vid_tpu_torch.models.txt import trainable
    if not config.end2end or gan.cond_encoder is None:
        return []
    return trainable(gan.cond_encoder)


def optimizer_params(gan, config: TrainConfig) -> tuple[list, list]:
    """(G's, D's) parameter lists, in the optimizers' order: the generator's
    and the discriminators', each followed by the encoder's under end2end
    (G's only with end2end_txt_in_g)."""
    txt = txt_params(gan, config)
    g = list(gan.gen.parameters()) + (txt if config.end2end_txt_in_g else [])
    return g, [p for d in gan.discrims for p in d.parameters()] + txt


def adam(params, lr: float = 2e-4, b1: float = 0.5, b2: float = 0.999,
         mu_dtype=None, nu_dtype=None):
    """optax.adam's update (eps 1e-8 added to the bias-corrected root of the
    second moment): torch's Adam with float32 moments, or, with a storage
    dtype for either moment, ops.optim.AdamStorage (--bf16's bf16 mu,
    --bf16_nu's bf16 nu)."""
    if mu_dtype is None and nu_dtype is None:
        return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)
    return AdamStorage(params, lr=lr, b1=b1, b2=b2, eps=1e-8, mu_dtype=mu_dtype,
                       nu_dtype=nu_dtype)


@contextlib.contextmanager
def param_copy(modules, dtype):
    """Inside the block every float32 parameter of `modules` reads as one copy
    in `dtype` made on entry (the JAX step's cast_tree): forwards, and
    backwards run inside the block (remat's recomputations too), use it, and
    gradients reach the float32 parameters through the cast. Buffers
    (BatchNorm's statistics) are not copied. dtype None: no copy."""
    if dtype is None:
        yield
        return
    swapped, seen = [], set()
    for module in modules:
        for m in module.modules():
            if id(m) in seen:
                continue
            seen.add(id(m))
            for name, p in list(m._parameters.items()):
                if p is not None and p.dtype == torch.float32:
                    m._parameters[name] = p.to(dtype)
                    swapped.append((m, name, p))
    try:
        yield
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_norm_(grads, norm, clip: float):
    """Scale `grads` in place so their global norm (`norm`, already computed)
    is at most `clip` (_clip_by_norm, train_step.py:129-138). A non-finite
    norm zeroes them, by select: inf * 0 would be NaN."""
    finite = torch.isfinite(norm)
    scale = torch.where(finite, torch.clamp(clip / torch.clamp(norm, min=1e-20), max=1.0),
                        torch.zeros_like(norm))
    for g in grads:
        g.copy_(torch.where(finite, g * scale, torch.zeros_like(g)))


def quarantine_nonfinite_(grads) -> torch.Tensor:
    """Zero in place every gradient tensor holding a non-finite value (by
    select) and return how many were zeroed, an int32 device scalar
    (_quarantine_nonfinite, train_step.py:141-158)."""
    ok = [torch.isfinite(g).all() for g in grads]
    for g, good in zip(grads, ok):
        g.copy_(torch.where(good, g, torch.zeros_like(g)))
    return torch.stack([~good for good in ok]).sum().to(torch.int32)


def _grads(params):
    """Each parameter's gradient, zeros where backward left None (optax steps
    every leaf, torch's Adam skips a None gradient)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def _norm_and_clip(params, clip: float):
    """The pre-clip global norm of the parameters' gradients (the metric),
    then the in-step clip when `clip` is set."""
    grads = _grads(params)
    norm = global_norm(grads)
    if clip:
        clip_by_norm_(grads, norm, clip)
    return norm


class TrainStep:
    """`step(batch, draws=None) -> metrics`. batch: "video" (B, T, H, W, C) float
    in [-1, 1] or uint8, and with a caption encoder "captions" (B, L) int and
    "lengths" (B,) on the host. Without `draws` they come from a CPU
    torch.Generator seeded from (seed, step). Metrics are device scalars:
    loss_d (summed over D steps), loss_g (summed over G sub-steps),
    grad_norm_d, grad_norm_g (pre-clip global norms of the last update of
    each phase) and, with gp_quarantine and gp_lambda > 0, gp_quarantined
    (int32). The optimizers hold `optimizer_params(gan, config)`."""

    def __init__(self, gan, losses, opt_g, opt_d, config: TrainConfig, seed: int = 0):
        check_config(config)
        self.gan = gan
        self.losses = losses
        self.opt_g = opt_g
        self.opt_d = opt_d
        self.config = config
        self.seed = seed
        self.step = 0
        self.txt_params = txt_params(gan, config)

    def draw(self, batch_size: int, device) -> Draws:
        """The step's draws from a CPU generator seeded from (seed, step): z,
        the phases, then per D step and discriminator its derangement and,
        with gp_lambda > 0, one (batch_size,) uniform per scale (every step,
        so the stream does not depend on the lazy-GP phase), then the
        generator's phases of each G sub-step after the first."""
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence([self.seed, self.step])
                            .generate_state(1)[0]))
        cfg = self.config
        z = torch.randn(batch_size, cfg.latent_size, generator=gen)
        n_pyr = len(cfg.frame_sizes) - 1 if cfg.subsample_input else 0
        pyramid = [int(torch.randint(0, 2, (), generator=gen)) for _ in range(n_pyr)]
        n_gen = getattr(self.gan.gen, "num_blocks", 1) - 1
        gen_phases = [int(torch.randint(0, 2, (), generator=gen)) for _ in range(n_gen)]
        d_steps = []
        for _ in range(cfg.discrim_steps):
            perms, alphas = [], [] if cfg.gp_lambda > 0 else None
            for _ in self.gan.discrims:
                perms.append(gen_perm_device(batch_size, generator=gen).to(device))
                if alphas is not None:
                    alphas.append([torch.rand(batch_size, generator=gen).to(device)
                                   for _ in cfg.frame_sizes])
            d_steps.append((perms, alphas))
        later_gen = [[int(torch.randint(0, 2, (), generator=gen)) for _ in range(n_gen)]
                     for _ in range(cfg.gen_steps - 1)]
        return Draws(z.to(device), pyramid, gen_phases, *d_steps[0],
                     later_d_steps=d_steps[1:], later_gen_phases=later_gen)

    def _scales(self, x, cond, phases):
        """The real pyramid and its conds (train_step.py:284-288)."""
        if self.config.img_model:
            return [x], (None if cond is None else [cond])
        return multiscale_pyramid(x, cond, list(self.config.frame_sizes), phases,
                                  self.config.subsample_input)

    def _d_loss(self, real_scales, fakes, conds, perms, alphas, gp_lambda,
                gp_only=False):
        gan, cfg = self.gan, self.config
        ls, _, _ = gan.all_discrim_forward(real_scales, fakes, conds(),
                                           loss=self.losses, perms=perms,
                                           gp_lambda=gp_lambda, alphas=alphas,
                                           gp_only=gp_only)
        total = gan.weighted_sum(ls)
        if cfg.mean_discrim_loss:
            total = total / cfg.discrim_steps
        return total

    def _d_step(self, d_params, real_scales, fakes, conds, perms, alphas):
        """One D update; `conds()` gives the cond pyramid of each loss (under
        end2end a fresh encoding). Returns (loss, pre-clip grad norm, zeroed
        GP leaves or None)."""
        cfg = self.config
        lazy = cfg.gp_lambda > 0 and cfg.gp_every > 1
        gp_on = cfg.gp_lambda > 0 and (not lazy or self.step % cfg.gp_every == 0)
        gp_scale = cfg.gp_lambda * (cfg.gp_every if lazy else 1)
        quarantined = None
        self.opt_d.zero_grad(set_to_none=True)
        if gp_on and cfg.gp_quarantine:
            loss = self._d_loss(real_scales, fakes, conds, perms, alphas, -1.0)
            loss.backward()
            loss_gp = self._d_loss(real_scales, fakes, conds, perms, alphas,
                                   gp_scale, gp_only=True)
            # a penalty that reaches no parameter (a discriminator that does
            # not read x) has no graph: its gradient is zeros
            g_gp = (torch.autograd.grad(loss_gp, d_params, allow_unused=True)
                    if loss_gp.requires_grad else [None] * len(d_params))
            g_gp = [torch.zeros_like(p) if g is None else g for p, g in zip(d_params, g_gp)]
            quarantined = quarantine_nonfinite_(g_gp)
            ok = torch.isfinite(loss_gp)
            quarantined = quarantined + (~ok).to(torch.int32)
            loss = loss + torch.where(ok, loss_gp, torch.zeros_like(loss_gp))
            torch._foreach_add_(_grads(d_params), g_gp)
        else:
            loss = self._d_loss(real_scales, fakes, conds, perms, alphas,
                                gp_scale if gp_on else -1.0)
            loss.backward()
        norm = _norm_and_clip(d_params, cfg.clip_grad)
        self.opt_d.step()
        if cfg.gp_quarantine and cfg.gp_lambda > 0 and quarantined is None:
            quarantined = torch.zeros((), dtype=torch.int32, device=loss.device)
        return loss.detach(), norm, quarantined

    def __call__(self, batch, draws: Draws | None = None):
        gan, cfg = self.gan, self.config
        x = batch["video"]
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        if draws is None:
            draws = self.draw(x.shape[0], x.device)

        has_cond = gan.cond_encoder is not None and batch.get("captions") is not None
        end2end = cfg.end2end and has_cond

        def encode():
            return gan.encode(batch["captions"], batch["lengths"])

        cond = None
        if has_cond:
            if end2end:
                gan.cond_encoder.train()
            with torch.no_grad():
                cond = encode()
        real_scales, cond_scales = self._scales(x, cond, draws.pyramid_phases)

        def live_conds():
            """The cond pyramid of a fresh encoding, with its gradient."""
            return self._scales(x, encode(), draws.pyramid_phases)[1]

        gan.gen.train()
        cdt = cfg.compute_dtype
        # the float32 parameters the optimizers update, taken outside the copies
        txt = self.txt_params
        g_params = list(gan.gen.parameters()) + (txt if cfg.end2end_txt_in_g else [])
        d_params = [p for d in gan.discrims for p in d.parameters()] + txt
        two_forward = cfg.gen_steps > 1 or end2end
        with param_copy([gan.gen], cdt):
            if two_forward:
                # the D phase's fakes: no gradient, BatchNorm statistics dropped
                with torch.no_grad(), frozen_batch_stats():
                    fakes = gan.generate(draws.z, cond=cond, train=True,
                                         phases=draws.gen_phases)
            else:
                fakes_live = gan.generate(draws.z, cond=cond, train=True,
                                          phases=draws.gen_phases)
                fakes = [f.detach() for f in fakes_live]
            if [f.shape[2:4] for f in fakes] != [r.shape[2:4] for r in real_scales]:
                raise ValueError(
                    f"generator pyramid {[tuple(f.shape[2:4]) for f in fakes]} does not "
                    f"match the frame_sizes pyramid "
                    f"{[tuple(r.shape[2:4]) for r in real_scales]}")

            # D phase: fakes detached, so the backward reaches only D's (and
            # under end2end the encoder's) parameters; every D step updates
            # against the same fakes, each from its own copy of the updated
            # parameters
            d_conds = live_conds if end2end else (lambda: cond_scales)
            loss_d = quarantined = None
            for j in range(cfg.discrim_steps):
                with param_copy(gan.discrims, cdt):
                    loss_j, grad_norm_d, q = self._d_step(
                        d_params, real_scales, fakes, d_conds, *draws.d_step(j))
                loss_d = loss_j if loss_d is None else loss_d + loss_j
                if q is not None:
                    quarantined = q if quarantined is None else quarantined + q

            # G phase, through the updated D
            if not two_forward:
                loss_g, grad_norm_g = self._shared_g_step(g_params, fakes_live,
                                                          real_scales, cond_scales)
        if two_forward:
            loss_g, grad_norm_g = self._g_steps(g_params, draws, real_scales, cond_scales,
                                                live_conds if end2end else None)

        self.step += 1
        metrics = {"loss_d": loss_d, "loss_g": loss_g,
                   "grad_norm_d": grad_norm_d, "grad_norm_g": grad_norm_g}
        if quarantined is not None:
            metrics["gp_quarantined"] = quarantined
        return metrics

    def _real_preds(self, real_scales, cond_scales):
        """The updated D's real predictions, without gradient."""
        with torch.no_grad():
            return self.gan.all_discrim_forward(real_scales, cond_scales=cond_scales)[2]

    def _gen_loss(self, fakes, real_preds, cond_scales):
        loss = self.gan.gen_loss(fakes, real_preds, cond_scales, loss=self.losses)
        if self.config.mean_gen_loss:
            loss = loss / self.config.gen_steps
        return loss

    def _shared_g_step(self, g_params, fakes_live, real_scales, cond_scales):
        """The G update pulled back through the D phase's generator forward
        (run inside that forward's parameter copy)."""
        gan, cfg = self.gan, self.config
        self.opt_g.zero_grad(set_to_none=True)
        with param_copy(gan.discrims, cfg.compute_dtype):
            real_preds = self._real_preds(real_scales, cond_scales)
            # the gradient w.r.t. the kept fakes, pulled back through the one
            # generator forward; autograd.grad leaves D's parameters alone
            leaves = [f.detach().requires_grad_() for f in fakes_live]
            loss_g = self._gen_loss(leaves, real_preds, cond_scales)
            dfakes = torch.autograd.grad(loss_g, leaves)
            torch.autograd.backward(fakes_live, dfakes)
        grad_norm_g = _norm_and_clip(g_params, cfg.clip_grad)
        self.opt_g.step()
        return loss_g.detach(), grad_norm_g

    def _g_steps(self, g_params, draws, real_scales, cond_scales, live_conds):
        """gen_steps G updates, each re-generating from draws.z. live_conds
        (end2end): re-encode with the encoder the D phase left, with gradient
        in every sub-step when the G optimizer holds the encoder, else once
        without."""
        gan, cfg = self.gan, self.config
        cdt = cfg.compute_dtype
        txt_in_g = live_conds is not None and cfg.end2end_txt_in_g
        real_preds = None
        if live_conds is not None and not txt_in_g:
            with torch.no_grad():
                cond_scales = live_conds()
        if not txt_in_g:
            with param_copy(gan.discrims, cdt):
                real_preds = self._real_preds(real_scales, cond_scales)
        # every sub-step's BatchNorm statistics start from the step's
        start = ({n: b.clone() for n, b in gan.gen.named_buffers()}
                 if cfg.gen_steps > 1 else None)
        buffers = dict(gan.gen.named_buffers())
        loss_g = grad_norm_g = None
        for j in range(cfg.gen_steps):
            if j:
                with torch.no_grad():
                    for n, b in start.items():
                        buffers[n].copy_(b)
            self.opt_g.zero_grad(set_to_none=True)
            with param_copy([gan.gen], cdt), param_copy(gan.discrims, cdt):
                if txt_in_g:
                    cond_scales = live_conds()
                    real_preds = gan.all_discrim_forward(real_scales,
                                                         cond_scales=cond_scales)[2]
                fakes = gan.generate(draws.z, cond=None if cond_scales is None
                                     else cond_scales[0], train=True,
                                     phases=draws.gen_step(j))
                loss = self._gen_loss(fakes, real_preds, cond_scales)
                # gradients of G's (and the encoder's) parameters alone
                grads = torch.autograd.grad(loss, g_params, allow_unused=True)
            for p, g in zip(g_params, grads):
                p.grad = g
            grad_norm_g = _norm_and_clip(g_params, cfg.clip_grad)
            self.opt_g.step()
            loss_g = loss.detach() if loss_g is None else loss_g + loss.detach()
        return loss_g, grad_norm_g


def build_train_step(gan, losses, opt_g, opt_d, config: TrainConfig,
                     seed: int = 0) -> TrainStep:
    """The port's counterpart of build_train_step: a TrainStep over `gan`
    (generator, discriminators, optional frozen caption encoder) and the two
    optimizers (see `adam`)."""
    return TrainStep(gan, losses, opt_g, opt_d, config, seed)


class ChunkStep:
    """--steps_per_dispatch k (the counterpart of JAX's scanned step,
    parallel/mesh.py jit_scanned_train_step_sharded): `step(chunk)` runs the
    wrapped TrainStep on each of the k batches of a (k, B, ...) chunk in turn
    and returns each metric stacked (k,) in step order. Every other attribute
    is the wrapped step's. The steps are the ones k single calls make: each
    draws from its own step counter."""

    def __init__(self, step: TrainStep, k: int):
        self.inner, self.k = step, int(k)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, chunk):
        metrics = [self.inner({key: v[j] for key, v in chunk.items()}) for j in range(self.k)]
        return {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}
