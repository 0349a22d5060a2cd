"""The inputs the benchmark makes from the seed: captions from the
moving-digit grammar, their token ids, and clips in the packed frame-cache
format ("T2VC1": a header of (offset, T, H, W, C) entries, then the uint8
frames), written here from its layout, with the caption pickle beside it.
"""

import pickle
import struct
from pathlib import Path

import numpy as np

MOTIONS = ("left and right", "right and left", "top and bottom", "bottom and top")
SPECIALS = ("<pad>", "<start>", "<end>", "<unk>")
PACKED_MAGIC = 0x0000314356325400


def captions(n: int, rng: np.random.Generator) -> list[str]:
    """n captions "digit D is MOTION."."""
    return [f"digit {int(rng.integers(0, 10))} is {MOTIONS[int(rng.integers(0, 4))]}."
            for _ in range(n)]


def words(caption: str) -> list[str]:
    """<start>, the lowercased words, <end> for a trailing '.' (and at the end)."""
    out = ["<start>"]
    for w in caption.lower().split():
        if w.endswith("."):
            out += [w[:-1], "<end>"]
        else:
            out.append(w)
    if out[-1] != "<end>":
        out.append("<end>")
    return out


def vocabulary() -> list[str]:
    """Every word of the grammar, ids in this order."""
    vocab = list(SPECIALS)
    for caption in [f"digit {d} is {m}." for d in range(10) for m in MOTIONS]:
        for w in words(caption):
            if w not in vocab:
                vocab.append(w)
    return vocab


def tokenize(caps, max_len: int):
    """-> (ids (N, max_len) int64 zero-padded, lengths (N,) int64)."""
    index = {w: i for i, w in enumerate(vocabulary())}
    ids = np.zeros((len(caps), max_len), np.int64)
    lengths = np.zeros((len(caps),), np.int64)
    for i, cap in enumerate(caps):
        toks = [index[w] for w in words(cap)][:max_len]
        ids[i, :len(toks)] = toks
        lengths[i] = len(toks)
    return ids, lengths


def clips(n: int, shape, rng: np.random.Generator) -> np.ndarray:
    """n uint8 noise clips of shape (T, H, W, C)."""
    return rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)


def write_packed(videos: np.ndarray, path: Path) -> None:
    """(n, T, H, W, C) uint8 -> one packed frame-cache file."""
    n, t, h, w, c = videos.shape
    header = 16 + n * 24
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", PACKED_MAGIC, n))
        for i in range(n):
            f.write(struct.pack("<QIIII", header + i * videos[0].nbytes, t, h, w, c))
        f.write(np.ascontiguousarray(videos).tobytes())


def write_dataset(root: Path, videos: np.ndarray, caps: list[str]) -> dict:
    """The packed clips, the {clip id: [caption]} pickle and the vocabulary
    pickle under `root`; returns the paths."""
    from txt2vid_tpu_torch.data.vocab import Vocab
    paths = {"data": root / "clips.t2vc", "anno": root / "sent.pickle",
             "vocab": root / "vocab.pickle"}
    write_packed(videos, paths["data"])
    with open(paths["anno"], "wb") as f:
        pickle.dump({i: [cap] for i, cap in enumerate(caps)}, f)
    vocab = Vocab()
    for w in vocabulary():
        vocab.add_word(w)
    with open(paths["vocab"], "wb") as f:
        pickle.dump(vocab, f)
    return paths


def signature(video: np.ndarray) -> bytes:
    """The bytes that identify a noise clip among the others."""
    return np.ascontiguousarray(video).reshape(-1)[:64].tobytes()
