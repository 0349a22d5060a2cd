"""Synthetic moving-digit videos (counterpart of txt2vid_tpu/data/synthetic.py).

A digit glyph moves linearly between two random points (horizontal or
vertical, bouncing back and forth, animation length in [0.1 T, T]); its
caption is "digit D is left and right." / "right and left" / "top and
bottom" / "bottom and top". `generate_examples` writes the JAX package's
layout: `<i>.npy` uint8 clips (T, H, W, C) and a {i: [caption]} pickle, with
the same random stream, so a seed gives the JAX package's captions and
motions, and the same clips byte for byte: the glyphs are the JAX package's
(PIL's default font), kept here as a table of its 16x16 canvases and resized
with PIL's nearest mapping, since the port does not use PIL. MNIST digits
from a local raw-MNIST copy are used as the JAX package uses them.
"""

import gzip
import pickle
import random
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.utils.misc import ensure_exists

# the captions' motions, in the order of the classes the evaluation scores
MOTION_CLASSES = ("left and right", "right and left", "top and bottom", "bottom and top")

# The ten 16x16 canvases the JAX package draws before its resize
# (txt2vid_tpu/data/synthetic.py:_glyph_digits): PIL's default font, the digit
# drawn at offsets (4 + dx, 2 + dy) for dx, dy in {0, 1}, as rendered by
# Pillow 12.1.0; each string is two rows of 16 uint8 pixels in hex. The port
# keeps them as data: it does not use PIL.
_CANVASES = {
    0: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000fb5ededb50f0000000000000000000091ecf5f5ec8f000000000000",
        "00000000ebf58082f5ea00000000000000000000fcfc1c1dfbfb000000000000",
        "00000000fdfd0404fdfd00000000000000000000fcfc1c1dfbfb000000000000",
        "00000000ebf58082f5eb0000000000000000000091ecf5f5ec90000000000000",
        "000000000fb5ededb50f00000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    1: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000010a6faf1000000000000000000000000c7f3fffe00000000000000",
        "0000000000c9e0fefe0000000000000000000000001818fefe00000000000000",
        "00000000000000fefe0000000000000000000000000000fefe00000000000000",
        "00000000000000fefe0000000000000000000000000000fefe00000000000000",
        "00000000000000f0f00000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    2: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000062daf4dd460000000000000000000015dcf6f6fbe2000000000000",
        "000000003adfd633fcfc0000000000000000000028705566faf7000000000000",
        "00000000000023e8f6a500000000000000000000000cd5f9e015000000000000",
        "0000000001b1f5e537000000000000000000000062fdfef5ecb4000000000000",
        "0000000061f8fcefecb400000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    3: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000aaceaf3dc4b000000000000000000007be7f4f4fbe9000000000000",
        "000000007fbb7756fcfb000000000000000000001117a5fcfee4000000000000",
        "000000000000a3fcfdba0000000000000000000093950451faf8000000000000",
        "00000000d8e5573ffcfb00000000000000000000adf1f4f2f5cf000000000000",
        "000000001ec7efeec62800000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    4: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000000004af9f70000000000000000000000000dd9ffff000000000000",
        "0000000000009af0fffe00000000000000000000003ce6e9fefe000000000000",
        "0000000007d6f3b7fefe000000000000000000005ff9fdf1ffffa20000000000",
        "000000005ae4f5efffffa200000000000000000000000000fefe000000000000",
        "0000000000000000f0f000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    5: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000045e7f7efe1840000000000000000000089f6faefe184000000000000",
        "00000000a8db9700000000000000000000000000c3eeefedbd23000000000000",
        "00000000cdf4f2f3f4c7000000000000000000009cc66d54fcfa000000000000",
        "00000000b3cb513cfbfa00000000000000000000b5f3f5f1f3c7000000000000",
        "0000000025cdf0edc22300000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    6: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000293e7f2ca22000000000000000000006be1f3f6f4b9000000000000",
        "00000000ddf19655e2d300000000000000000000fafde1ecda87000000000000",
        "00000000feffe8f2f3c500000000000000000000fdfe5555fcfa000000000000",
        "00000000f0f44343fbfa00000000000000000000a1eaf1f2f4c5000000000000",
        "0000000016baeceec42300000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    7: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "00000000a8eaeff1fbec00000000000000000000a8eaeff6fef6000000000000",
        "00000000000001e2f28d0000000000000000000000004ff2ee16000000000000",
        "000000000000d4f0a900000000000000000000000037f0ef2700000000000000",
        "0000000000bff0c400000000000000000000000024f0f13e0000000000000000",
        "0000000024cfc700000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    8: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000043d5f1f0d03900000000000000000000e8fbf2f2f8df000000000000",
        "00000000f9fb4e52fcfa00000000000000000000d7fefefefeea000000000000",
        "00000000cefefefefebb00000000000000000000fbfc5457faf8000000000000",
        "00000000fbfc3f3efcfb00000000000000000000d1f7f4f3f7d6000000000000",
        "000000002fccf0f0cc3000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
    9: (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000",
        "0000000021c2eeecbb1700000000000000000000c4f3f2f1eaa0000000000000",
        "00000000fafb4545f4f000000000000000000000fafb5356fefd000000000000",
        "00000000c6f3f1e7fefe000000000000000000008bdbece1fdfa000000000000",
        "00000000d5e35497f1dd00000000000000000000b9f4f6f4e16c000000000000",
        "0000000024ccf2e7940200000000000000000000000000000000000000000000",
        "0000000000000000000000000000000000000000000000000000000000000000"),
}


def moving_digit_captions(n: int, seed: int = 0) -> list[str]:
    """n captions "digit D is MOTION." drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [f"digit {int(rng.integers(0, 10))} is "
            f"{MOTION_CLASSES[int(rng.integers(0, len(MOTION_CLASSES)))]}." for _ in range(n)]


def _canvas(d: int) -> np.ndarray:
    return np.frombuffer(bytes.fromhex("".join(_CANVASES[d])), np.uint8).reshape(16, 16)


def nearest_index(size: int, n: int = 16) -> np.ndarray:
    """The source pixel of each of `size` output pixels when PIL's
    Image.resize(..., NEAREST) maps n pixels to `size`: the sample position
    starts at half a step and grows by one step of n / size in float64 (the
    additions' rounding included), truncated (ImagingScaleAffine)."""
    step = n / size
    pos = step * 0.5
    out = np.empty(size, np.int64)
    for i in range(size):
        out[i] = int(pos)
        pos += step
    return out


def _glyph_digits(size: int = 28):
    """Digits 0-9 as [(size, size) uint8 glyph], the JAX package's glyphs:
    its 16x16 canvases resized to `size` with PIL's nearest mapping."""
    idx = nearest_index(size)
    return {d: [np.ascontiguousarray(_canvas(d)[idx][:, idx])] for d in _CANVASES}


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
