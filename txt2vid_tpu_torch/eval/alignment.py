"""Caption-video alignment for the synthetic moving-digit data (counterpart of
txt2vid_tpu/eval/alignment.py).

The four motion classes ("left and right" / "right and left" / "top and
bottom" / "bottom and top") are recovered from the brightness-centroid track
of a video: the motion axis from the track's larger variance, the direction
from the first clear displacement (clips start at the caption's first-named
end). The digit is recovered by correlating a glyph-sized crop at the
centroid with the dataset's glyph templates (`_digit_templates`: the
generator's own glyphs, data/synthetic._glyph_digits, or the per-class mean
of the local MNIST digits the data was generated from).

`alignment_report` samples k videos per motion class from a checkpoint
(digits cycled, a fresh z per batch from gan/trainer.draw_z) and reports the
4-way, axis and digit accuracy against the conditioning captions, the
confusion matrix and `cond_spread`, the caption encodings' mean pairwise
distance (about 1e-3 for a collapsed encoder, about 2 for a healthy one).

    python -m txt2vid_tpu_torch.eval.alignment --weights out/iter_... \\
        --G G.json --D D.json --sent txt2vid_tpu.models.txt.Seq2Seq \\
        --vocab vocab.pickle --frame_sizes 8 16 32 64 --num_frames 16 \\
        --num_channels 1 --k_per_class 32 --seed 5 [--ema] [--device cpu]
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from txt2vid_tpu_torch.data.synthetic import MOTION_CLASSES


def caption_motion_class(sentence: str):
    s = sentence.lower()
    for i, m in enumerate(MOTION_CLASSES):
        if m in s:
            return i
    return None


def _brightness(video):
    v = np.asarray(video, np.float32)
    return v[..., 0] / 255.0 if v.max() > 2.0 else (v[..., 0] + 1.0) / 2.0


def centroid_track(video: np.ndarray) -> np.ndarray:
    """(T, H, W, C) video (uint8 or [-1, 1]) -> (T, 2) brightness-centroid
    track (x, y), weighting each pixel by how far it clears a per-frame
    threshold."""
    bright = _brightness(video)
    t, h, w = bright.shape
    flat = bright.reshape(t, -1)
    thresh = np.maximum(0.25, flat.mean(1, keepdims=True)
                        + 0.5 * flat.std(1, keepdims=True))
    wgt = np.clip(flat - thresh, 0.0, None).reshape(t, h, w)
    wgt_sum = wgt.sum(axis=(1, 2)) + 1e-8
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    cx = (wgt.sum(axis=1) * xs).sum(axis=1) / wgt_sum
    cy = (wgt.sum(axis=2) * ys).sum(axis=1) / wgt_sum
    return np.stack([cx, cy], axis=1)


def classify_motion(video: np.ndarray):
    """-> (class index into MOTION_CLASSES, axis 0 horizontal / 1 vertical)."""
    track = centroid_track(video)
    cx, cy = track[:, 0], track[:, 1]
    horizontal = cx.var() > cy.var()
    line = cx if horizontal else cy
    d = line - line[0]
    sig = np.nonzero(np.abs(d) > max(1.0, 0.15 * (line.max() - line.min())))[0]
    sign = d[sig[0]] > 0 if len(sig) else (d[np.abs(d).argmax()] > 0)
    if horizontal:
        cls = 0 if sign else 1
    else:
        cls = 2 if sign else 3
    return cls, (0 if horizontal else 1)


def classify_batch(videos) -> np.ndarray:
    return np.asarray([classify_motion(np.asarray(v))[0] for v in videos])


def _digit_templates(size: int = 28, mnist_path=None):
    """(10, size, size) zero-mean unit-norm templates from the run's glyph
    source: the MNIST digits at `mnist_path` (28 px, per-class mean) if the
    data was generated from them, else the generator's glyphs at `size`."""
    from txt2vid_tpu_torch.data.synthetic import _glyph_digits, _mnist_digits
    glyphs = _mnist_digits(mnist_path) if mnist_path else None
    if glyphs is None:
        glyphs = _glyph_digits(size)
    t = np.stack([np.mean([g.astype(np.float32) / 255.0 for g in gs], axis=0)
                  for gs in glyphs.values()])
    t -= t.mean(axis=(1, 2), keepdims=True)
    return t / (np.linalg.norm(t.reshape(10, -1), axis=1)[:, None, None] + 1e-8)


def classify_digit(video: np.ndarray, templates=None) -> int:
    """The moving digit: per frame, the best correlation of each template with
    a crop at the brightness centroid (shifted by up to 3 px), summed over
    frames. The 49 shifted crops of every frame are correlated at once; the
    JAX package loops over them, summing in another order."""
    if templates is None:
        templates = _digit_templates()
    bright = _brightness(video)
    track = centroid_track(video)
    th, tw = templates.shape[1:]
    t, h, w = bright.shape
    shifts = np.arange(-3, 4)
    ys = np.clip(np.round(track[:, 1] - th / 2)[:, None] + shifts, 0, h - th).astype(np.int64)
    xs = np.clip(np.round(track[:, 0] - tw / 2)[:, None] + shifts, 0, w - tw).astype(np.int64)
    rows = (ys[:, :, None] + np.arange(th))[:, :, None, :, None]      # (T, 7, 1, th, 1)
    cols = (xs[:, :, None] + np.arange(tw))[:, None, :, None, :]      # (T, 1, 7, 1, tw)
    patches = bright[np.arange(t)[:, None, None, None, None], rows, cols].reshape(t, 49, -1)
    patches = patches - patches.mean(axis=2, keepdims=True)
    norm = np.linalg.norm(patches, axis=2) + 1e-8
    corr = (patches @ templates.reshape(10, -1).T) / norm[..., None]     # (T, 49, 10)
    votes = corr.max(axis=1).sum(axis=0)
    return int(votes.argmax())


def alignment_report(gan, vocab, k_per_class: int = 32, digits=range(10), seed: int = 0,
                     batch_size: int = 40, mnist_path=None):
    """Sample k_per_class videos per motion class (digits cycled) from the
    gan's generator and caption encoder, on their device, z drawn per batch
    (gan/trainer.sample with a generator seeded from `seed`); classify the
    motion and the digit against the captions."""
    from txt2vid_tpu_torch.data import encode_caption, pad_captions
    from txt2vid_tpu_torch.gan.trainer import sample

    digits = list(digits)
    caps, labels = [], []
    for ci, motion in enumerate(MOTION_CLASSES):
        for k in range(k_per_class):
            caps.append(f"digit {digits[k % len(digits)]} is {motion}.")
            labels.append(ci)
    labels = np.asarray(labels)

    toks, lengths = pad_captions([encode_caption(vocab, c) for c in caps])

    digit_labels = np.asarray([digits[k % len(digits)]
                               for _ in MOTION_CLASSES for k in range(k_per_class)])
    templates = _digit_templates(mnist_path=mnist_path)

    device = next(gan.gen.parameters()).device
    generator = torch.Generator().manual_seed(seed)
    preds, digit_preds, conds = [], [], []
    for i in range(0, len(caps), batch_size):
        with torch.no_grad():
            cond = gan.encode(torch.as_tensor(toks[i:i + batch_size], device=device),
                              lengths[i:i + batch_size])
        conds.append(cond.float().cpu().numpy())
        vids = sample(gan.gen, cond.shape[0], generator, cond=cond)[-1]
        preds.append(classify_batch(vids))
        digit_preds.append([classify_digit(v, templates) for v in vids])
    preds = np.concatenate(preds)
    digit_preds = np.concatenate(digit_preds)
    cond_all = np.concatenate(conds)
    sub = cond_all[np.random.default_rng(0).permutation(len(cond_all))[:64]]
    cond_spread = float(np.mean(np.linalg.norm(sub[:, None, :] - sub[None, :, :], axis=-1)))

    conf = np.zeros((4, 4), np.int64)
    for lab, p in zip(labels, preds):
        conf[lab, p] += 1
    axis = (preds >= 2) == (labels >= 2)
    return {"accuracy_4way": float((preds == labels).mean()),
            "accuracy_axis": float(axis.mean()),
            "accuracy_digit": float((digit_preds == digit_labels).mean()),
            "chance_4way": 0.25, "chance_axis": 0.5, "chance_digit": 0.1,
            "cond_spread": cond_spread,
            "n": int(len(labels)), "confusion": conf.tolist()}


def real_data_ceiling(video_dir, sent_pickle, n: int = 200, num_frames: int = 16,
                      mnist_path=None):
    """The classifiers' accuracy on REAL clips against their own captions (the
    ceiling of the generated-sample metric)."""
    from txt2vid_tpu_torch.data import load_pickle, load_video_frames

    sents = load_pickle(sent_pickle)
    templates = _digit_templates(mnist_path=mnist_path)
    ok = ok_digit = total = 0
    for vid, caps in list(sents.items())[:n]:
        cls = caption_motion_class(caps[0])
        if cls is None:
            continue
        v = load_video_frames(Path(video_dir) / str(vid), num_frames=num_frames,
                              num_channels=1)
        pred, _ = classify_motion(v)
        ok += int(pred == cls)
        ok_digit += int(classify_digit(v, templates) == int(caps[0].split()[1]))
        total += 1
    return {"real_accuracy_4way": ok / max(total, 1),
            "real_accuracy_digit": ok_digit / max(total, 1), "n": total}


def main(args):
    """Score a checkpoint; prints the report as JSON and returns it."""
    from txt2vid_tpu_torch.gan.cond_gan import load_checkpoint_gan
    from txt2vid_tpu_torch.train.setup import setup
    from txt2vid_tpu_torch.utils import status

    _, device = setup(args)
    status(f"Restoring {args.weights}{' (EMA generator)' if args.ema else ''}")
    gan, vocab = load_checkpoint_gan(
        args.weights, args.G, args.D, sent=args.sent or "txt2vid_tpu.models.txt.Seq2Seq",
        vocab_path=args.vocab, frame_sizes=tuple(args.frame_sizes),
        num_frames=args.num_frames, num_channels=args.num_channels, ema=args.ema,
        M=args.M)
    gan.gen.to(device)
    gan.cond_encoder.to(device).eval()
    report = alignment_report(gan, vocab, k_per_class=args.k_per_class, seed=args.seed,
                              batch_size=args.batch_size, mnist_path=args.mnist)
    if args.real_videos:
        report.update(real_data_ceiling(args.real_videos, args.real_sents,
                                        mnist_path=args.mnist))
    print(json.dumps(report, indent=2))
    return report


def build_parser():
    p = argparse.ArgumentParser(description="Caption-video alignment of a checkpoint.")
    p.add_argument("--weights", required=True)
    p.add_argument("--G", required=True)
    p.add_argument("--D", nargs="+", required=True)
    p.add_argument("--sent", default=None)
    p.add_argument("--M", default=None,
                   help="the sample mapping the checkpoint was trained with (--M, e.g. "
                        "TCWYT's FrameMap); only its variables are restored")
    p.add_argument("--vocab", required=True)
    p.add_argument("--frame_sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_channels", type=int, default=1)
    p.add_argument("--k_per_class", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--real_videos", default=None,
                   help="optional real video dir for the classifier ceiling")
    p.add_argument("--real_sents", default=None)
    p.add_argument("--mnist", default=None,
                   help="raw-MNIST dir if the training data was generated with --mnist")
    p.add_argument("--ema", action="store_true",
                   help="score the sibling <weights>.ema generator average")
    p.add_argument("--device", default=None, help="default: cuda")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
