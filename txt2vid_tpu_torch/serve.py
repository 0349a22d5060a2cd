"""Persistent caption->video generation service (counterpart of
txt2vid_tpu/serve.py), eval mode on the GPU.

Requests are tokenized, padded to a fixed (batch_size, max_caption_len) and
chunked, exactly as the JAX service does. Each chunk runs the eval-mode Bi-LSTM
caption encoding, a z draw, eval-mode generation (running-stat BatchNorm, final
scale only) and [-1, 1] -> uint8 quantization on the device; only the uint8
video goes back to the host. The generator's non-local attention runs through
the fused CUDA kernel (ops/fused_attention.py).

`python -m txt2vid_tpu_torch.serve --bench N` times N videos and prints one JSON
line. Without `--weights` the flagship conditional model is built from `--seed`
with random weights and a vocabulary of the synthetic moving-digit captions.
Serving in bf16 waits for a later slice.
"""

import argparse
import json
import time

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.data import build_vocab, encode_caption, load_pickle
from txt2vid_tpu_torch.data.synthetic import moving_digit_captions
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.models import tganv2, tganv2_cond
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.initializers import init_from_seed


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
        toks = np.zeros((len(sentences), self.max_caption_len), np.int64)
        lens = np.zeros((len(sentences),), np.int64)
        for i, s in enumerate(sentences):
            c = encode_caption(self.vocab, s)[:self.max_caption_len]
            toks[i, :len(c)] = c
            lens[i] = len(c)
        return toks, lens

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
                  max_caption_len: int = 16, device=None):
        """The flagship conditional model (tganv2_cond.MultiScaleGen: 64 px, 16
        frames, latent 256 + cond 256, fm_channels 1024, additional_blocks
        (64, 32, 32); Seq2Seq embed 256, hidden 256, 4 layers) with random weights
        from `seed`. Without a vocab the generator is unconditional."""
        device = resolve_device(device)
        txt = None
        if vocab is not None:
            txt = init_from_seed(Seq2Seq(vocab_size=len(vocab)), seed + 1)
        cond_dim = txt.encoding_size if txt is not None else 0
        gen = init_from_seed(tganv2_cond.MultiScaleGen(cond_dim=cond_dim), seed)
        return cls(CondGan(gen, txt), vocab=vocab, batch_size=batch_size,
                   max_caption_len=max_caption_len, device=device)

    @classmethod
    def from_checkpoint(cls, weights, vocab_path=None, batch_size: int = 8,
                        max_caption_len: int = 16, device=None):
        """Load a file written by `save_checkpoint`."""
        device = resolve_device(device)
        ckpt = torch.load(weights, map_location="cpu", weights_only=True)
        gen = tganv2.MultiScaleGen(**ckpt["gen_config"])
        gen.load_state_dict(ckpt["generator"])
        vocab = load_pickle(vocab_path) if vocab_path else None
        txt = None
        if ckpt.get("encoder") is not None:
            txt = Seq2Seq(**ckpt["enc_config"])
            txt.load_state_dict(ckpt["encoder"])
        return cls(CondGan(gen, txt), vocab=vocab, batch_size=batch_size,
                   max_caption_len=max_caption_len, device=device)


def save_checkpoint(path, gen_config: dict, gen_state: dict,
                    enc_config: dict | None = None, enc_state: dict | None = None):
    """Write the port's serving checkpoint: the generator's constructor kwargs
    (tganv2.MultiScaleGen) and state dict, and the caption encoder's
    (txt.Seq2Seq), e.g. from txt2vid_tpu_torch.convert."""
    torch.save({"gen_config": gen_config, "generator": gen_state,
                "enc_config": enc_config, "encoder": enc_state}, path)


def main(args):
    # float32 convolutions and matmuls in float32, not TF32 (the JAX package's
    # semantics; cuDNN would take TF32 by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.weights:
        svc = GeneratorService.from_checkpoint(
            args.weights, vocab_path=args.vocab, batch_size=args.batch_size,
            max_caption_len=args.max_caption_len, device=args.device)
    else:
        vocab = (load_pickle(args.vocab) if args.vocab
                 else build_vocab(moving_digit_captions(1000, args.seed)))
        svc = GeneratorService.from_seed(
            vocab, seed=args.seed, batch_size=args.batch_size,
            max_caption_len=args.max_caption_len, device=args.device)

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
            "cond": sentences is not None,
            "device": (torch.cuda.get_device_name(svc.device)
                       if svc.device.type == "cuda" else str(svc.device)),
        }))
        return

    out = svc.generate(sentences=sentences, num=args.num_samples, seed=args.seed)
    np.save(args.out, out)
    print(f"wrote {args.out}: uint8 {out.shape}")


def cli(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default=None,
                   help="checkpoint from save_checkpoint; without it the flagship "
                        "model is built from --seed with random weights")
    p.add_argument("--vocab", default=None)
    p.add_argument("--sentences", nargs="+", default=None)
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_caption_len", type=int, default=16)
    p.add_argument("--bench", type=int, default=0,
                   help="measure throughput over N videos, print one JSON line")
    p.add_argument("--out", default="serve_out.npy",
                   help="where the uint8 (N, T, H, W, C) videos are saved")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    main(p.parse_args(argv))


if __name__ == "__main__":
    cli()
