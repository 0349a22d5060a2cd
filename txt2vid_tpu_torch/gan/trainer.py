"""Host-side training loop (counterpart of txt2vid_tpu/gan/trainer.py:20-557).

`train` drives epochs and batches around a port TrainStep: rolling-average
losses and sec/iter per log period, checkpoints with loss-encoded names
(utils/checkpoint.py, the JAX package's format) and an `.ema` sibling under
--g_ema, sample grids from the live and the EMA generator, and NanAbort.

With --steps_per_dispatch k (trainer.py:268-505) each item of the dataset is
a chunk of k batches that `train_step` runs back to back, returning each
metric stacked (k,) in step order: the iteration advances by k, log, save
and sample fire at the chunk's end when a period's boundary falls inside it
(iteration % period < k; a save not before iteration `period`), the sample
grids show the chunk's last batch, the EMA moves once per chunk with
decay**k, and the per-iteration times are divided by k.

Metrics stay on the device until a log or save boundary and are then fetched
in one transfer. The fetch checks them: a non-finite loss, a non-finite grad
norm with no --clip_grad guard, a streak of --nan_abort_streak non-finite
norms in one phase, or --nan_abort_window_count of them within the last
--nan_abort_window steps raise NanAbort. The drain runs before every save, so
a poisoned state is never written; a burst of non-finite norms in the last
100 steps (3 or more) skips the save.

Sample grids are PNG files written by a zlib encoder here (the port does not
use PIL); the JAX package's `test()` writes its fakes as .jpg, the port as .png.
"""

import argparse
import struct
import zlib
from collections import deque

import numpy as np
import torch

from txt2vid_tpu_torch.convert import torch_state_to_jax
from txt2vid_tpu_torch.gan.cond_gan import as_list
from txt2vid_tpu_torch.utils import RollingAvg, Stopwatch, ensure_exists, status
from txt2vid_tpu_torch.utils.checkpoint import AsyncCheckpointer, checkpoint_name


class NanAbort(RuntimeError):
    """Raised by train() when fetched metrics show the run is poisoned or a
    phase frozen (trainer.py:20-39); the latest checkpoint on disk predates
    the event."""

    def __init__(self, iteration: int, what: str):
        self.iteration = iteration
        self.what = what
        super().__init__(f"non-finite {what} at iteration {iteration}")


def add_params_to_parser(parser: argparse.ArgumentParser):
    """Engine flags (trainer.py:42-111)."""
    parser.add_argument('--data_is_imgs', action='store_true', default=False)
    parser.add_argument('--img_model', action='store_true', default=False)
    parser.add_argument('--log_period', type=int, default=20)
    parser.add_argument('--loss_window_size', type=int, default=20)
    parser.add_argument('--no_mean_discrim_loss', action='store_false', default=True)
    parser.add_argument('--no_mean_gen_loss', action='store_false', default=True)
    parser.add_argument('--sample_batch_size', type=int, default=None)
    parser.add_argument('--discrim_steps', type=int, default=1)
    parser.add_argument('--gen_steps', type=int, default=1)
    parser.add_argument('--gp_lambda', type=float, default=-1)
    parser.add_argument('--gp_every', type=int, default=1,
                        help='lazy GP regularization: apply the gradient penalty '
                             'only every k-th step with its weight scaled by k '
                             '(1 = every step)')
    parser.add_argument('--gp_quarantine', action='store_true', default=False,
                        help="compute the GP term's gradient as a separate backward "
                             "pass and zero only its non-finite leaves, keeping the "
                             "main-loss D gradient; quarantined leaves are counted "
                             "in the status line")
    parser.add_argument('--save_initial', action='store_true', default=False)
    parser.add_argument('--save_initial_examples', action='store_true', default=False)
    parser.add_argument('--save_model_period', type=int, default=100)
    parser.add_argument('--save_example_period', type=int, default=100)
    parser.add_argument('--use_writer', action='store_true', default=False)
    parser.add_argument('--out', type=str, default='out')
    parser.add_argument('--out_samples', type=str, default='out_samples')
    parser.add_argument('--subsample_input', action='store_true', default=False)
    parser.add_argument('--host_snapshot', action='store_true', default=False,
                        help='checkpoint snapshots copy to the host at once (no '
                             'extra device memory) instead of cloning on the device')
    parser.add_argument('--rss_limit_gb', type=float, default=100.0,
                        help='end training cleanly (final checkpoint, resumable) if '
                             'process RSS exceeds this; 0 disables')
    parser.add_argument('--no_nan_abort', dest='nan_abort', action='store_false',
                        default=True,
                        help='disable aborting (exit 42) when fetched metrics show a '
                             'poisoned run: non-finite loss, unclipped non-finite '
                             'grad norm, or a frozen clipped phase')
    parser.add_argument('--nan_abort_streak', type=int, default=100,
                        help='with --clip_grad, abort after this many CONSECUTIVE '
                             'non-finite grad norms in one phase')
    parser.add_argument('--nan_abort_window', type=int, default=200,
                        help='with --clip_grad, also abort when '
                             '--nan_abort_window_count non-finite grad norms land '
                             'within this many trailing steps of one phase (the '
                             'lazy-GP lock-in); 0 disables')
    parser.add_argument('--nan_abort_window_count', type=int, default=20,
                        help='non-finite fetches within --nan_abort_window steps '
                             'that trigger the abort')
    parser.add_argument('--g_ema', type=float, default=0.0,
                        help='decay of an exponential moving average of the '
                             'generator params (e.g. 0.999), sampled beside the live '
                             'generator and saved as a sibling <checkpoint>.ema file '
                             '(gan/ema.py); 0 disables')
    return parser


def to_grid(video_batch) -> np.ndarray:
    """(B, T, H, W, C) in [-1, 1] (or uint8) -> a uint8 grid, one row per video."""
    v = np.asarray(video_batch)
    if v.ndim == 4:
        v = v[:, None]
    b, t, h, w, c = v.shape
    if v.dtype != np.uint8:
        v = ((np.clip(v, -1, 1) + 1.0) * 127.5).astype(np.uint8)
    pad = 2
    grid = np.zeros((b * (h + pad) + pad, t * (w + pad) + pad, c), np.uint8)
    for i in range(b):
        for j in range(t):
            y, x = pad + i * (h + pad), pad + j * (w + pad)
            grid[y:y + h, x:x + w] = v[i, j]
    return grid


def png_bytes(image: np.ndarray) -> bytes:
    """An 8-bit grayscale (H, W) / (H, W, 1) or RGB (H, W, 3) PNG."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    color = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def save_frames(video_batch, path: str):
    with open(path, "wb") as f:
        f.write(png_bytes(to_grid(video_batch)))


def save_sentences(captions, path: str, vocab=None):
    with open(path, "w") as f:
        for cap in np.asarray(captions):
            f.write(vocab.to_words(cap) + "\n")


def draw_z(batch_size: int, latent_size: int, generator: torch.Generator):
    """The z of one sample() call: N(0, 1) drawn on the host from `generator`.
    sample() is how the sampling CLIs (sample, eval.run, eval.alignment) draw
    z, so replacing this function gives them other draws (the JAX package's
    z, which jax.random draws, in the parity tests)."""
    return torch.randn(batch_size, latent_size, generator=generator)


@torch.no_grad()
def sample(gen, batch_size: int, generator: torch.Generator, cond=None,
           latent_size: int | None = None):
    """Eval-mode generation: running-statistics BatchNorm, no subsampling, the
    final scale only. z comes from draw_z. Returns a list of scales as numpy
    arrays (one, for a single-scale generator; images (B, H, W, C) for an
    image generator, which the grids show as 1-frame videos); the
    generator's train/eval mode is restored."""
    device = next(gen.parameters()).device
    z = torch.as_tensor(draw_z(batch_size, latent_size or gen.latent_size, generator),
                        dtype=torch.float32)
    was_training = gen.training
    gen.eval()
    try:
        out = gen(z.to(device), cond=cond, train=False)
    finally:
        gen.train(was_training)
    return [o.float().cpu().numpy() for o in as_list(out)]


@torch.no_grad()
def encode(gan, batch):
    if gan.cond_encoder is None or "captions" not in batch:
        return None
    return gan.encode(batch["captions"], batch["lengths"])


def test(gan=None, num_samples=1, dataset=None, params=None, vocab=None, ema=None):
    """Sampling mode (trainer.py:182-222): each of `num_samples` rounds takes
    a fresh batch (wrapping the epoch) and writes real_{i}.png,
    sentences_{i}.txt and fake_{i}_{H}x{W}.png, and with `ema` (gan/ema.py)
    fake_ema_{i}_{H}x{W}.png from the averaged generator."""
    from txt2vid_tpu_torch.gan.ema import with_ema_params
    ensure_exists(params.out_samples)
    generator = torch.Generator().manual_seed(getattr(params, "seed", 0) or 0)
    ema_gen = with_ema_params(gan.gen, ema) if ema is not None else None
    it = iter(dataset)
    for i in range(num_samples):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(dataset)
            batch = next(it)
        x = batch["video"].cpu().numpy()
        cond = encode(gan, batch)
        save_frames(x, f"{params.out_samples}/real_{i}.png")
        if cond is not None and vocab is not None:
            save_sentences(batch["captions"].cpu(),
                           f"{params.out_samples}/sentences_{i}.txt", vocab)
        for tag, gen in (("fake", gan.gen), ("fake_ema", ema_gen)):
            if gen is None:
                continue
            for f in sample(gen, x.shape[0], generator, cond=cond):
                h, w = f.shape[-3], f.shape[-2]
                path = f"{params.out_samples}/{tag}_{i}_{h}x{w}.png"
                status(f"saving to {path}")
                save_frames(f, path)


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def train(gan=None, train_step=None, num_epoch=None, dataset=None, params=None,
          vocab=None, seed: int = 0, on_iteration=None, ema=None):
    """Epoch loop (trainer.py:225-557). `train_step` is a port TrainStep over
    `gan` (with --steps_per_dispatch k > 1 a train_step.ChunkStep of k);
    `dataset` yields batch dicts (chunks of k) already on the device;
    iterations continue from train_step.step (a restored checkpoint's)."""
    from txt2vid_tpu_torch.gan import ema as ema_mod
    ensure_exists(params.out)
    ensure_exists(params.out_samples)

    writer = None
    if getattr(params, "use_writer", False):
        from txt2vid_tpu_torch.utils.writer import MetricsWriter
        writer = MetricsWriter(params.out)

    gen_loss = RollingAvg(params.loss_window_size)
    discrim_loss = RollingAvg(params.loss_window_size)
    gnorm = {"d": RollingAvg(params.loss_window_size), "g": RollingAvg(params.loss_window_size)}
    nonfinite_gnorm = {"d": 0, "g": 0}
    gp_quarantined = [0]
    avg_data_load = RollingAvg(params.log_period)
    avg_iter = RollingAvg(params.log_period)
    data_watch, iter_watch = Stopwatch(), Stopwatch()
    sample_gen = torch.Generator().manual_seed(seed)
    iteration = int(train_step.step)

    snapshot = "host" if getattr(params, "host_snapshot", False) else "device"
    checkpointer = AsyncCheckpointer(snapshot=snapshot)
    k_step = getattr(params, "steps_per_dispatch", 1) or 1
    ema_decay = getattr(params, "g_ema", 0.0) or 0.0
    ema_update = ema_checkpointer = None
    if ema_decay:
        if ema is None:
            ema = ema_mod.init_ema(gan.gen)
        ema_update = ema_mod.make_ema_update(ema_decay, k_step)
        ema_checkpointer = AsyncCheckpointer(snapshot=snapshot)

    def save_checkpoint(path):
        checkpointer.save(torch_state_to_jax(train_step), path)
        if ema_checkpointer is not None:
            ema_checkpointer.save(ema_mod.ema_tree(ema, gan.gen), ema_mod.ema_path(path))

    pending = []   # (iteration, device metrics)
    nan_abort = getattr(params, "nan_abort", True)
    clip_on = bool(getattr(params, "clip_grad", 0) or 0)
    abort_streak = getattr(params, "nan_abort_streak", 100) or 0
    gnorm_streak = {"d": 0, "g": 0}
    abort_window = getattr(params, "nan_abort_window", 200) or 0
    abort_window_count = getattr(params, "nan_abort_window_count", 20) or 0
    nonfinite_recent = {"d": deque(), "g": deque()}
    phase_names = {"d": "discriminator", "g": "generator"}

    def _abort(it, what):
        status(f"NAN_ABORT: non-finite {what} at iteration {it}")
        checkpointer.wait()
        if ema_checkpointer is not None:
            ema_checkpointer.wait()
        if writer is not None:
            writer.close()
        raise NanAbort(it, what)

    def _window_check(phase, it):
        rec = nonfinite_recent[phase]
        rec.append(it)
        horizon = max(abort_window, 100)
        while rec and rec[0] <= it - horizon:
            rec.popleft()
        if not (abort_window and abort_window_count):
            return
        n = sum(1 for s in rec if s > it - abort_window)
        if nan_abort and clip_on and n >= abort_window_count:
            _abort(it, "%s grad norm %d times within the last %d steps — sustained "
                   "poisoning under the clip guard (lazy-GP lock-in)"
                   % (phase_names[phase], n, abort_window))

    def _check_norm(phase, value, it):
        if np.isfinite(value):
            gnorm[phase].update(value)
            gnorm_streak[phase] = 0
            return
        nonfinite_gnorm[phase] += 1
        gnorm_streak[phase] += 1
        if nan_abort and not clip_on:
            _abort(it, f"{phase_names[phase]} grad norm with no --clip_grad guard "
                       "(the update poisons the params)")
        if nan_abort and abort_streak and gnorm_streak[phase] >= abort_streak:
            _abort(it, "%s grad norm %d times consecutively — the clip guard is "
                   "zeroing every update (frozen phase)" % (phase_names[phase],
                                                           gnorm_streak[phase]))
        _window_check(phase, it)

    def drain_pending():
        if not pending:
            return
        keys = sorted(pending[0][1])
        # one transfer for every pending metric; a chunk's are (k,) in step
        # order, `it` the iteration of its last step
        flat = torch.stack([torch.stack([m[k].float().reshape(-1) for k in keys])
                            for _, m in pending]).cpu()
        rows = []
        for (last, _), chunk in zip(pending, flat.tolist()):
            steps = list(zip(*chunk))
            rows += [(last - len(steps) + 1 + j, dict(zip(keys, row)))
                     for j, row in enumerate(steps)]
        for it, m in rows:
            ld, lg = m["loss_d"], m["loss_g"]
            discrim_loss.update(ld)
            gen_loss.update(lg)
            if nan_abort and not (np.isfinite(ld) and np.isfinite(lg)):
                _abort(it, "loss (params are poisoned)")
            _check_norm("d", m["grad_norm_d"], it)
            _check_norm("g", m["grad_norm_g"], it)
            if "gp_quarantined" in m:
                gp_quarantined[0] += int(m["gp_quarantined"])
                if writer is not None and int(m["gp_quarantined"]):
                    writer.add_scalar("gp_quarantined", int(m["gp_quarantined"]), it)
            if writer is not None:
                writer.add_scalar("loss/discrim", ld, it)
                writer.add_scalar("loss/gen", lg, it)
                writer.add_scalar("grad_norm/discrim", m["grad_norm_d"], it)
                writer.add_scalar("grad_norm/gen", m["grad_norm_g"], it)
        pending.clear()

    def _gfmt(name, avg, bad):
        if len(avg) == 0 and bad == 0:
            return ""
        s = " |g|%s: %s" % (name, "%.2f" % avg.get() if len(avg) else "-")
        if bad:
            s += " (%d non-finite!)" % bad
        return s

    rss_limit = getattr(params, "rss_limit_gb", 0) or 0
    stop = False
    for epoch in range(num_epoch):
        if stop:
            break
        if params.log_period > 0:
            status(f"Epoch {epoch + 1} started")
        data_watch.start()
        iter_watch.start()
        for i, batch in enumerate(dataset):
            avg_data_load.update(data_watch.stop() / k_step)
            iteration += k_step

            metrics = train_step(batch)
            if ema_update is not None:
                ema_update(ema, gan.gen)
            pending.append((iteration, metrics))
            if len(pending) >= 512:
                drain_pending()

            first = iteration <= k_step
            if (first and params.save_initial) or (
                    params.save_model_period > 0
                    and iteration % params.save_model_period < k_step
                    and iteration >= params.save_model_period):
                drain_pending()
                burst = any(sum(1 for s in rec if s > iteration - 100) >= 3
                            for rec in nonfinite_recent.values())
                if burst:
                    status(f"skipping checkpoint at iteration {iteration}: non-finite "
                           "burst in progress (state mid-onset)")
                else:
                    save_checkpoint(f"{params.out}/"
                                    f"{checkpoint_name(iteration, gen_loss.get(), discrim_loss.get())}")

            if rss_limit and iteration % 100 < k_step and _rss_gb() > rss_limit:
                status(f"RSS {_rss_gb():.1f} GB exceeds --rss_limit_gb {rss_limit}: "
                       "ending cleanly (resume with --resume)")
                stop = True
                break

            if params.log_period > 0 and iteration % params.log_period < k_step:
                drain_pending()
                gn = _gfmt("D", gnorm["d"], nonfinite_gnorm["d"]) + \
                    _gfmt("G", gnorm["g"], nonfinite_gnorm["g"])
                if gp_quarantined[0]:
                    gn += " GPq: %d" % gp_quarantined[0]
                status("[%d/%d; %d/%d] - Iter %d, Loss_D: %.4f Loss_G: %.4f%s - "
                       "%.4f sec/iter; %.4f sec/batch load" % (
                           epoch, num_epoch, i, len(dataset), iteration,
                           discrim_loss.get(), gen_loss.get(), gn,
                           avg_iter.get(), avg_data_load.get()))

            if params.save_example_period > 0 and (
                    (first and params.save_initial_examples)
                    or iteration % params.save_example_period < k_step):
                if k_step > 1:      # a (k, B, ...) chunk: its last batch
                    batch = {k: v[-1] for k, v in batch.items()}
                _save_examples(gan, batch, params, vocab, epoch, iteration, sample_gen, ema)

            if on_iteration is not None:
                on_iteration(iteration, train_step)

            data_watch.start()
            avg_iter.update(iter_watch.stop() / k_step)
            iter_watch.start()

    drain_pending()
    # final checkpoint: an epoch-bounded run resumes from its last iteration
    if params.save_model_period > 0 and iteration % params.save_model_period:
        save_checkpoint(f"{params.out}/"
                        f"{checkpoint_name(iteration, gen_loss.get(), discrim_loss.get())}")
    checkpointer.wait()
    if ema_checkpointer is not None:
        ema_checkpointer.wait()
    if writer is not None:
        writer.close()
    return train_step


def _save_examples(gan, batch, params, vocab, epoch, iteration, generator, ema):
    """Real and fake sample grids (trainer.py:505-536): the batch, its
    captions, and `sample_batch_size` fakes from the live generator and, with
    EMA on, from the averaged one, at every scale the eval generator renders."""
    from txt2vid_tpu_torch.gan.ema import with_ema_params
    out = params.out_samples
    status(f"saving samples to {out} (iteration {iteration})")
    save_frames(batch["video"].cpu().numpy(), f"{out}/real_samples.png")
    cond = encode(gan, batch)
    if cond is not None and vocab is not None:
        save_sentences(batch["captions"].cpu(),
                       f"{out}/sentences_epoch{epoch:03d}_iter_{iteration:06d}.txt", vocab)
    nb = params.sample_batch_size or batch["video"].shape[0]
    if cond is not None:
        cond = cond[:nb]
    state = generator.get_state()
    gens = [("fake_samples", gan.gen)]
    if ema is not None:
        gens.append(("fake_ema_samples", with_ema_params(gan.gen, ema)))
    for tag, gen in gens:
        generator.set_state(state)          # the same z for both generators
        for f in sample(gen, nb, generator, cond=cond):
            h, w = f.shape[-3], f.shape[-2]
            save_frames(f, f"{out}/{tag}_epoch_{epoch:03d}_iter_{iteration:06d}_{h}x{w}.png")
