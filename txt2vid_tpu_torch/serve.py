"""Persistent caption->video generation service (counterpart of
txt2vid_tpu/serve.py), eval mode on the GPU.

Requests are tokenized, padded to a fixed (batch_size, max_caption_len) and
chunked, exactly as the JAX service does. Each chunk runs the eval-mode Bi-LSTM
caption encoding, a z draw, eval-mode generation (running-stat BatchNorm, final
scale only) and [-1, 1] -> uint8 quantization on the device; only the uint8
video goes back to the host. The generator's non-local attention runs through
the fused CUDA kernel (ops/fused_attention.py).

`GeneratorService.from_checkpoint` serves a training checkpoint (the JAX
package's flax-msgpack format, which the port's trainer writes too) from the
--G / --D / --sent specs it was trained with, optionally the `.ema` sibling's
generator average, as txt2vid_tpu/serve.py:101-145 does:

    python -m txt2vid_tpu_torch.serve --weights out/iter_6_... \
        --G "$GC3" --D "$DC3" --sent txt2vid_tpu.models.txt.Seq2Seq \
        --vocab vocab.pickle --frame_sizes 32 64 128 --num_frames 32 \
        --num_channels 1 [--ema] [--out_samples DIR]

writes one PNG grid per sample (--format png). Without --weights the
flagship conditional model is built from --seed with random weights and a
vocabulary of the synthetic moving-digit captions. `--bench N` times N videos
and prints one JSON line. `--bf16` builds the generator with dtype bf16
(float32 parameters cast at each use, bf16 activations and attention, the
caption encoder float32), as txt2vid_tpu/serve.py:121-122 does; the uint8
quantization runs on a float32 copy of the video. `--format gif|avi|mp4|webm`
writes one clip per sample (utils/video.py: .gif without any library, the
others through OpenCV where it is installed).
"""

import argparse
import json
import time

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.data import build_vocab, encode_caption, load_pickle, pad_captions
from txt2vid_tpu_torch.data.synthetic import moving_digit_captions
from txt2vid_tpu_torch.gan.cond_gan import CondGan, load_checkpoint_gan
from txt2vid_tpu_torch.models import tganv2_cond
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.utils import ensure_exists, status
from txt2vid_tpu_torch.utils.video import save_video_batch

VIDEO_FORMATS = ("gif", "avi", "mp4", "webm")


def quantize(video):
    """[-1, 1] float -> uint8, truncating as the JAX service's astype does."""
    return ((video.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


class GeneratorService:
    """Wraps a CondGan (generator + optional caption encoder) into a fixed-shape
    batched generator. `generate(sentences)` / `generate(num=n)` takes any
    request size: requests are chunked and padded to the batch size."""

    def __init__(self, gan, vocab=None, batch_size: int = 8,
                 max_caption_len: int = 16, device=None):
        self.device = resolve_device(device)
        self.gan = gan
        self.vocab = vocab
        self.batch_size = batch_size
        self.max_caption_len = max_caption_len
        gan.gen.to(self.device).eval()
        if gan.cond_encoder is not None:
            gan.cond_encoder.to(self.device).eval()
        self._has_cond = gan.cond_encoder is not None and vocab is not None

    def _tokenize(self, sentences):
        return pad_captions([encode_caption(self.vocab, s) for s in sentences],
                            self.max_caption_len)

    def _draw_z(self, seed: int, chunk: int):
        """The chunk's z, from a generator seeded by (seed, chunk)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.SeedSequence([seed, chunk]).generate_state(1)[0]))
        return torch.randn(self.batch_size, self.gan.gen.latent_size,
                           generator=gen, device=self.device)

    @torch.inference_mode()
    def _video(self, toks, lens, z):
        """One chunk -> the final scale as float (B, T, H, W, C) on the device.
        toks (B, L) and lens (B,) host or device ints, z (B, latent)."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        cond = None
        if self._has_cond:
            toks = torch.as_tensor(toks, dtype=torch.long, device=self.device)
            cond = self.gan.encode(toks, lens)
        return self.gan.generate(z, cond=cond, train=False)[-1]

    def _run(self, toks, lens, z):
        """One chunk -> uint8 (B, T, H, W, C) on the device."""
        return quantize(self._video(toks, lens, z))

    def _chunks(self, sentences=None, num: int | None = None):
        """-> (n, [(toks, lens), ...]): the requests tokenized and padded to whole
        chunks of batch_size. N = len(sentences) or `num`."""
        if sentences is not None:
            n = len(sentences)
            toks, lens = self._tokenize(sentences)
        else:
            n = num if num is not None else self.batch_size
            toks = np.zeros((n, self.max_caption_len), np.int64)
            lens = np.ones((n,), np.int64)

        b = self.batch_size
        pad = (-n) % b
        if pad:
            toks = np.concatenate([toks, np.zeros((pad, toks.shape[1]), np.int64)])
            lens = np.concatenate([lens, np.ones((pad,), np.int64)])
        return n, [(toks[i:i + b], lens[i:i + b]) for i in range(0, n + pad, b)]

    def generate(self, sentences=None, num: int | None = None, seed: int = 0):
        """-> uint8 numpy (N, T, H, W, C). N = len(sentences) or `num`."""
        n, chunks = self._chunks(sentences, num)
        outs = [self._run(toks, lens, self._draw_z(seed, i))
                for i, (toks, lens) in enumerate(chunks)]
        return torch.cat(outs)[:n].cpu().numpy()

    @classmethod
    def from_seed(cls, vocab=None, seed: int = 0, batch_size: int = 8,
                  max_caption_len: int = 16, device=None, bf16: bool = False):
        """The flagship conditional model (tganv2_cond.MultiScaleGen: 64 px, 16
        frames, latent 256 + cond 256, fm_channels 1024, additional_blocks
        (64, 32, 32); Seq2Seq embed 256, hidden 256, 4 layers) with random weights
        from `seed`. Without a vocab the generator is unconditional; `bf16`
        computes the generator in bfloat16."""
        device = resolve_device(device)
        txt = None
        if vocab is not None:
            txt = init_from_seed(Seq2Seq(vocab_size=len(vocab)), seed + 1)
        cond_dim = txt.encoding_size if txt is not None else 0
        gen = init_from_seed(tganv2_cond.MultiScaleGen(
            cond_dim=cond_dim, dtype=torch.bfloat16 if bf16 else None), seed)
        return cls(CondGan(gen, txt), vocab=vocab, batch_size=batch_size,
                   max_caption_len=max_caption_len, device=device)

    @classmethod
    def from_checkpoint(cls, weights, G, D, sent=None, vocab_path=None,
                        frame_sizes=(8, 16, 32, 64), num_frames=16, num_channels=3,
                        batch_size: int = 8, max_caption_len: int = 16, bf16: bool = False,
                        ema: bool = False, device=None):
        """A training checkpoint (load_checkpoint_gan) served at batch_size."""
        gan, vocab = load_checkpoint_gan(weights, G, D, sent=sent, vocab_path=vocab_path,
                                         frame_sizes=frame_sizes, num_frames=num_frames,
                                         num_channels=num_channels, bf16=bf16, ema=ema)
        return cls(gan, vocab=vocab, batch_size=batch_size,
                   max_caption_len=max_caption_len, device=device)


def main(args):
    """Serve from --weights (or the random-weight flagship); returns the uint8
    videos (N, T, H, W, C), or None with --bench."""
    # float32 convolutions and matmuls in float32, not TF32 (the JAX package's
    # semantics; cuDNN would take TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.weights:
        if not (args.G and args.D):
            raise ValueError("--weights needs the --G and --D specs it was trained with")
        svc = GeneratorService.from_checkpoint(
            args.weights, args.G, args.D, sent=args.sent, vocab_path=args.vocab,
            frame_sizes=tuple(args.frame_sizes), num_frames=args.num_frames,
            num_channels=args.num_channels, batch_size=args.batch_size,
            max_caption_len=args.max_caption_len, bf16=args.bf16, ema=args.ema,
            device=args.device)
    else:
        vocab = (load_pickle(args.vocab) if args.vocab
                 else build_vocab(moving_digit_captions(1000, args.seed)))
        svc = GeneratorService.from_seed(
            vocab, seed=args.seed, batch_size=args.batch_size,
            max_caption_len=args.max_caption_len, device=args.device, bf16=args.bf16)

    sentences = args.sentences
    if sentences is None and svc.vocab is not None:
        sentences = moving_digit_captions(args.num_samples, args.seed)

    if args.bench:
        n = args.bench
        if sentences is not None:
            sentences = (sentences * (n // len(sentences) + 1))[:n]
        svc.generate(sentences=sentences, num=n, seed=0)        # warm-up, kernel build
        t0 = time.perf_counter()
        out = svc.generate(sentences=sentences, num=n, seed=1)  # ends in a D2H copy
        dt = time.perf_counter() - t0
        print(json.dumps({
            "metric": "serve_videos_per_sec", "value": n / dt,
            "unit": "videos/sec", "ms_per_video": 1e3 * dt / n,
            "batch_size": svc.batch_size, "n": n,
            "shape": list(out.shape[1:]), "dtype": "uint8",
            "compute_dtype": "bf16" if args.bf16 else "f32",
            "cond": sentences is not None,
            "device": (torch.cuda.get_device_name(svc.device)
                       if svc.device.type == "cuda" else str(svc.device)),
        }))
        return None

    from txt2vid_tpu_torch.gan.trainer import save_frames
    out = svc.generate(sentences=sentences, num=args.num_samples, seed=args.seed)
    ensure_exists(args.out_samples)
    if args.format == "png":
        paths = []
        for i, v in enumerate(out):
            paths.append(f"{args.out_samples}/serve_{i}.png")
            save_frames(v[None], paths[-1])          # uint8 passes through to_grid
    else:
        paths = save_video_batch(out, f"{args.out_samples}/serve_{{i}}.{args.format}",
                                 fps=args.fps)
    for path in paths:
        status(f"wrote {path}")
    return out


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default=None,
                   help="a training checkpoint (iter_*); without it the flagship model "
                        "is built from --seed with random weights")
    p.add_argument("--G", default=None, help="the generator spec the checkpoint was "
                                             "trained with (needed with --weights)")
    p.add_argument("--D", nargs="+", default=None,
                   help="the discriminator specs it was trained with")
    p.add_argument("--sent", default=None, help="the caption encoder spec")
    p.add_argument("--vocab", default=None)
    p.add_argument("--sentences", nargs="+", default=None)
    p.add_argument("--frame_sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_caption_len", type=int, default=16)
    p.add_argument("--bf16", action="store_true", default=False,
                   help="compute the generator in bfloat16 (float32 parameters)")
    p.add_argument("--ema", action="store_true", default=False,
                   help="serve the sibling <weights>.ema generator average instead of "
                        "the live parameters (gan/ema.py)")
    p.add_argument("--bench", type=int, default=0,
                   help="measure throughput over N videos, print one JSON line")
    p.add_argument("--format", default="png", choices=["png", *VIDEO_FORMATS],
                   help="png = one grid image per sample; video formats = one playable "
                        "clip per sample (utils/video.py)")
    p.add_argument("--fps", type=int, default=8, help="frame rate of the video formats")
    p.add_argument("--out_samples", default="out_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
