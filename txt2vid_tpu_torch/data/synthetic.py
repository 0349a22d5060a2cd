"""Synthetic moving-digit videos (counterpart of txt2vid_tpu/data/synthetic.py).

A digit glyph moves linearly between two random points (horizontal or
vertical, bouncing back and forth, animation length in [0.1 T, T]); its
caption is "digit D is left and right." / "right and left" / "top and
bottom" / "bottom and top". `generate_examples` writes the JAX package's
layout: `<i>.npy` uint8 clips (T, H, W, C) and a {i: [caption]} pickle, with
the same random stream, so a seed gives the JAX package's captions and
motions. The glyphs differ: the JAX package renders PIL's default font, and
the port, which does not use PIL, draws digits from a 5x7 bitmap table at the
same size and stroke weight; the pixels differ, the format and captions do
not. MNIST digits from a local raw-MNIST copy are used as the JAX package
uses them.
"""

import gzip
import pickle
import random
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.utils.misc import ensure_exists

_MOTIONS = ("left and right", "right and left", "top and bottom", "bottom and top")

# 5x7 bitmaps of the digits 0-9, one string of five columns per row
_FONT = {
    0: ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    1: ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    2: ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    3: ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    4: ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    5: ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    6: ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    7: ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    8: ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    9: ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
}


def moving_digit_captions(n: int, seed: int = 0) -> list[str]:
    """n captions "digit D is MOTION." drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [f"digit {int(rng.integers(0, 10))} is "
            f"{_MOTIONS[int(rng.integers(0, len(_MOTIONS)))]}." for _ in range(n)]


def _glyph_digits(size: int = 28):
    """Digits 0-9 as (size, size) uint8 glyphs: the 5x7 bitmap drawn at 2x on
    a 16x16 canvas at offset taps (0/1 in x and y) for a bold stroke, then
    resized nearest to `size`, as the JAX package draws PIL's font."""
    glyphs = {}
    for d, rows in _FONT.items():
        bitmap = np.array([[c == "1" for c in r] for r in rows], np.uint8)
        big = np.kron(bitmap, np.ones((2, 2), np.uint8)) * 255       # (14, 10)
        canvas = np.zeros((16, 16), np.uint8)
        for dx in (0, 1):
            for dy in (0, 1):
                y, x = 1 + dy, 3 + dx
                canvas[y:y + 14, x:x + 10] |= big
        idx = (np.arange(size) * 16) // size
        glyphs[d] = [canvas[idx][:, idx]]
    return glyphs


def _mnist_digits(mnist_path: str, per_class: int = 50):
    """Digits from a local raw-MNIST images/labels pair, if there is one."""
    p = Path(mnist_path)
    imgs_f = p / "train-images-idx3-ubyte.gz"
    labels_f = p / "train-labels-idx1-ubyte.gz"
    if not imgs_f.exists():
        return None
    with gzip.open(imgs_f) as f:
        data = np.frombuffer(f.read(), np.uint8, offset=16).reshape(-1, 28, 28)
    with gzip.open(labels_f) as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    glyphs = {d: [] for d in range(10)}
    for img, lab in zip(data, labels):
        if len(glyphs[int(lab)]) < per_class:
            glyphs[int(lab)].append(img)
    return glyphs


def render_video(glyph: np.ndarray, frame_size, num_frames, animation_len,
                 from_pt, to_pt, repeat=True, num_channels=1):
    """The glyph's position interpolated from from_pt to to_pt over
    animation_len frames, bouncing back and repeating (synthetic.py:58-79)."""
    w, h = frame_size
    gh, gw = glyph.shape[:2]
    frames = np.zeros((num_frames, h, w, num_channels), dtype=np.uint8)
    a, b = np.asarray(from_pt, float), np.asarray(to_pt, float)
    pos, tgt = a.copy(), b.copy()
    steps = max(animation_len, 1)
    vel = (tgt - pos) / steps
    for t in range(num_frames):
        x = int(np.clip(round(pos[0]), 0, w - gw))
        y = int(np.clip(round(pos[1]), 0, h - gh))
        patch = glyph[..., None] if glyph.ndim == 2 else glyph
        frames[t, y:y + gh, x:x + gw] = np.broadcast_to(patch, (gh, gw, num_channels))
        pos = pos + vel
        if repeat and (np.linalg.norm(pos - tgt) < np.linalg.norm(vel) + 1e-6
                       or not (0 <= pos[0] <= w and 0 <= pos[1] <= h)):
            tgt = a.copy() if np.allclose(tgt, b) else b.copy()
            vel = (tgt - pos) / steps
    return frames


def generate_examples(video_dir, sentence_out, num_examples=100, frame_size=(64, 64),
                      num_frames=64, seed=300, mnist_path=None, num_channels=1):
    """Write `<i>.npy` clips to video_dir and the {i: [caption]} pickle to
    sentence_out (synthetic.py:82-130); returns the caption dict."""
    ensure_exists(video_dir)
    rng_py = random.Random(seed)
    rng = np.random.default_rng(seed)
    w, h = frame_size

    glyphs = _mnist_digits(mnist_path) if mnist_path else None
    if glyphs is None:
        glyphs = _glyph_digits()

    sent_map = {}
    for i in range(num_examples):
        digit = int(rng.integers(0, 10))
        glyph = glyphs[digit][int(rng.integers(0, len(glyphs[digit])))]
        gh, gw = glyph.shape[:2]

        animation_length = rng_py.randint(int(0.1 * num_frames), num_frames)
        horizontal = rng_py.randint(0, 1)
        l2r_u2d = rng_py.randint(0, 1)

        sentence = f"digit {digit} is "
        if horizontal:
            y = int(rng.integers(0, h))
            x1 = int(rng.integers(0, max(int(0.1 * w), 1)))
            x2 = int(rng.integers(int(0.9 * w), w))
            a, b = np.array([x1, y]), np.array([x2, y])
            sentence += "left and right" if l2r_u2d else "right and left"
        else:
            x = int(rng.integers(0, w))
            y1 = int(rng.integers(0, max(int(0.1 * h), 1)))
            y2 = int(rng.integers(int(0.9 * h), h))
            a, b = np.array([x, y1]), np.array([x, y2])
            sentence += "top and bottom" if l2r_u2d else "bottom and top"
        if not l2r_u2d:
            a, b = b, a
        sentence += "."

        a[0] = np.clip(a[0], 0, w - gw)
        a[1] = np.clip(a[1], 0, h - gh)
        b[0] = np.clip(b[0], 0, w - gw)
        b[1] = np.clip(b[1], 0, h - gh)

        frames = render_video(glyph, frame_size, num_frames, animation_length,
                              a, b, repeat=True, num_channels=num_channels)
        np.save(Path(video_dir) / f"{i}.npy", frames)
        sent_map[i] = [sentence]

    with open(sentence_out, "wb") as f:
        pickle.dump(sent_map, f)
    return sent_map


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description="Write the synthetic moving-digit dataset.")
    parser.add_argument("--out", type=str, required=True, help="output root dir")
    parser.add_argument("--num_train", type=int, default=40000)
    parser.add_argument("--num_test", type=int, default=10000)
    parser.add_argument("--num_frames", type=int, default=64)
    parser.add_argument("--frame_size", type=int, default=64)
    parser.add_argument("--mnist", type=str, default=None, help="optional local raw-MNIST dir")
    args = parser.parse_args()
    for split, n, seed in (("train", args.num_train, 300), ("test", args.num_test, 301)):
        root = Path(args.out) / split
        ensure_exists(root)
        generate_examples(root / "videos", root / "sent.pickle", num_examples=n,
                          frame_size=(args.frame_size, args.frame_size),
                          num_frames=args.num_frames, seed=seed, mnist_path=args.mnist)
        print(f"{split}: {n} examples -> {root}")
