"""Sample-from-checkpoint CLI (counterpart of txt2vid_tpu/sample.py): load a
training checkpoint, optionally its `.ema` generator average, encode captions
and write the samples - one PNG grid per scale, or one playable clip per
sample in a video format (utils/video.py).

    python -m txt2vid_tpu_torch.sample --weights out/iter_... \\
        --G txt2vid_tpu.models.tganv2_cond.MultiScaleGen \\
        --D txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim \\
        --vocab vocab.pickle --sentences "digit 3 is left and right." \\
        --out_samples samples/ [--ema] [--format gif] [--device cpu]

z comes from gan/trainer.sample, drawn from --seed by torch's generator
(not jax.random's), so the videos match the JAX package's given the same z.
"""

import argparse

import torch

from txt2vid_tpu_torch.data import encode_caption, pad_captions
from txt2vid_tpu_torch.gan.trainer import sample, save_frames
from txt2vid_tpu_torch.gan.cond_gan import load_checkpoint_gan
from txt2vid_tpu_torch.train.setup import setup
from txt2vid_tpu_torch.utils import ensure_exists, status
from txt2vid_tpu_torch.utils.video import save_video_batch


def main(args):
    """Writes the samples; returns the final scale's videos (N, T, H, W, C)."""
    _, device = setup(args)
    status(f"Restoring {args.weights}{' (EMA generator)' if args.ema else ''}")
    gan, vocab = load_checkpoint_gan(
        args.weights, args.G, args.D, sent=args.sent,
        vocab_path=None if args.dont_use_sent else args.vocab,
        frame_sizes=tuple(args.frame_sizes), num_frames=args.num_frames,
        num_channels=args.num_channels, ema=args.ema, M=args.M)
    gan.gen.to(device)

    cond, n = None, args.num_samples
    if gan.cond_encoder is not None and args.sentences:
        gan.cond_encoder.to(device).eval()
        toks, lens = pad_captions([encode_caption(vocab, s) for s in args.sentences])
        with torch.no_grad():
            cond = gan.encode(torch.as_tensor(toks, device=device), lens)
        n = len(toks)

    ensure_exists(args.out_samples)
    fakes = sample(gan.gen, n, torch.Generator().manual_seed(args.seed), cond=cond)
    for f in fakes:
        h, w = f.shape[-3], f.shape[-2]
        if args.format == "png":
            paths = [f"{args.out_samples}/sample_{h}x{w}.png"]
            save_frames(f, paths[0])
        else:
            paths = save_video_batch(f, f"{args.out_samples}/sample_{h}x{w}_{{i}}.{args.format}",
                                     fps=args.fps)
        for path in paths:
            status(f"wrote {path}")
    return fakes[-1]


def build_parser():
    p = argparse.ArgumentParser(description="Sample videos from a training checkpoint.")
    p.add_argument("--weights", required=True)
    p.add_argument("--G", required=True)
    p.add_argument("--D", nargs="+", required=True)
    p.add_argument("--M", default=None,
                   help="the sample mapping the checkpoint was trained with (--M, e.g. "
                        "TCWYT's FrameMap); only its variables are restored")
    p.add_argument("--sent", default=None)
    p.add_argument("--vocab", default=None)
    p.add_argument("--dont_use_sent", action="store_true")
    p.add_argument("--sentences", nargs="+", default=None)
    p.add_argument("--frame_sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--out_samples", default="out_samples")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ema", action="store_true",
                   help="sample with the sibling <weights>.ema generator average")
    p.add_argument("--format", default="png", choices=["png", "gif", "avi", "mp4", "webm"],
                   help="png = one grid image per scale; video formats = one playable "
                        "clip per sample (utils/video.py)")
    p.add_argument("--fps", type=int, default=8, help="frame rate of the video formats")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
