"""Host-side data for the port (counterpart of txt2vid_tpu/data/__init__.py):
caption vocabulary, the video dataset, collation and a threaded loader.

- VideoDataset indexes a {video_id: [captions]} pickle into (video, caption)
  pairs, skipping missing videos, and reads `<vid>.npy` uint8 (T, H, W, C)
  clips or directories of `<n>.jpg`/`.png` frames (the original code's cache
  layout, read with PIL), picking `num_frames` evenly spaced (or sorted
  random) frames.
- collate pads captions to a static `max_caption_len` and returns lengths.
- Loader is a shuffling epoch iterator whose worker threads keep
  num_workers + 1 batches decoded ahead; it yields host numpy batches (uint8
  video unless normalize=True). The trainer moves them to the device.
- BatchLoader does the same for batch-level datasets, which assemble whole
  batches themselves (`get_batch`, the packed frame cache of data/packed.py);
  get_loader picks it for them.
- cifar10_dataset (data/cifar10.py) yields CIFAR-10 images without captions,
  for the image GAN.
- ShardedView is one data-parallel rank's strided share of a dataset.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.data.vocab import (Vocab, build_vocab, encode_caption, load_pickle,
                                         pad_captions)

__all__ = ["ShardedView", "Vocab", "build_vocab", "encode_caption", "load_pickle",
           "pad_captions", "VideoDataset", "transform_frames", "collate", "Loader",
           "BatchLoader", "get_loader", "my_dataset", "cifar10_dataset"]


def pick_frames(num_available: int, num_frames: int = 16, random: bool = False,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """Evenly spaced frame indices, or sorted uniform random ones (:87-98)."""
    if not random:
        factor = num_available // num_frames
        return np.arange(num_frames) * max(factor, 1)
    rng = rng or np.random.default_rng()
    idx = rng.permutation(num_available)[:num_frames]
    idx.sort()
    return idx


def load_video_frames(path: Path, num_frames: int = 16, frame_size: int | None = None,
                      num_channels: int = 3, random_frames: bool = False, rng=None,
                      normalize: bool = True) -> np.ndarray:
    """A cached clip as (T, H, W, C): float32 in [-1, 1], or uint8 with
    normalize=False (:108-132). The clip is `<vid>.npy` uint8 (T, H, W, C),
    or a directory of `<n>.jpg` / `<n>.png` frames taken in the order of n
    (`.jpg` where both exist), read with PIL."""
    if path.suffix == ".npy" or path.with_suffix(".npy").exists():
        arr = np.load(path if path.suffix == ".npy" else path.with_suffix(".npy"),
                      mmap_mode="r")
        idx = pick_frames(arr.shape[0], num_frames, random_frames, rng)
        frames = np.asarray(arr[idx])
    else:
        from PIL import Image        # only this layout needs PIL
        names = sorted(int(f.stem) for f in path.iterdir() if f.suffix in (".jpg", ".png"))
        idx = pick_frames(len(names), num_frames, random_frames, rng)
        files = [path / f"{names[i]}.jpg" for i in idx]
        frames = np.stack([np.asarray(Image.open(f if f.exists() else f.with_suffix(".png")))
                           for f in files])
    if frames.ndim == 3:
        frames = frames[..., None]
    return transform_frames(frames, frame_size, num_channels, normalize=normalize)


def transform_frames(frames: np.ndarray, frame_size: int | None,
                     num_channels: int, normalize: bool = True) -> np.ndarray:
    """Centre crop (zero padding when smaller), the channel policy (ITU-R 601
    luma for 3 -> 1, repeat for 1 -> 3) and [-1, 1] normalisation (:135-163).
    normalize=False keeps uint8."""
    t, h, w, c = frames.shape
    if frame_size is not None and (h < frame_size or w < frame_size):
        ph, pw = max(0, frame_size - h), max(0, frame_size - w)
        frames = np.pad(frames, ((0, 0), (ph // 2, ph - ph // 2),
                                 (pw // 2, pw - pw // 2), (0, 0)))
        t, h, w, c = frames.shape
    if frame_size is not None and (h != frame_size or w != frame_size):
        top = max(0, (h - frame_size) // 2)
        left = max(0, (w - frame_size) // 2)
        frames = frames[:, top:top + frame_size, left:left + frame_size]
    if num_channels == 1 and frames.shape[-1] == 3:
        luma = frames @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
        frames = luma[..., None]
        if not normalize:
            frames = frames.astype(np.uint8)
    elif num_channels == 3 and frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    if not normalize:
        return np.ascontiguousarray(frames)
    frames = frames.astype(np.float32) / 255.0
    return frames * 2.0 - 1.0


class VideoDataset:
    """(video, caption) pairs over a directory of `<vid>.npy` clips or frame
    directories and a captions pickle (:166-203)."""

    def __init__(self, video_dir=None, vocab=None, captions=None, num_frames=16,
                 frame_size=None, num_channels=3, random_frames=0, normalize=True):
        self.video_dir = Path(video_dir)
        self.vocab = vocab
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.num_channels = num_channels
        self.random_frames = bool(random_frames)
        self.normalize = normalize

        caps = load_pickle(captions) if isinstance(captions, (str, Path)) else captions
        self.video_ids, self.captions = [], []
        self.missing = 0
        for vid in caps:
            p = self.video_dir / str(vid)
            if not (p.exists() or p.with_suffix(".npy").exists()):
                self.missing += 1
                continue
            for cap in caps[vid]:
                self.video_ids.append(str(vid))
                self.captions.append(cap)
        if self.missing:
            print(f"Missing: {self.missing} videos")

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        frames = load_video_frames(self.video_dir / self.video_ids[idx], self.num_frames,
                                   self.frame_size, self.num_channels,
                                   self.random_frames, normalize=self.normalize)
        caption = encode_caption(self.vocab, self.captions[idx]) \
            if self.vocab is not None else None
        return frames, caption


def collate(items, max_caption_len: int = 32):
    """Stack videos; pad captions to a static max_caption_len (:206-217)."""
    vids = np.stack([v for v, _ in items])
    if items[0][1] is None:
        return {"video": vids}
    lengths = np.asarray([min(len(c), max_caption_len) for _, c in items], dtype=np.int32)
    caps = np.zeros((len(items), max_caption_len), dtype=np.int32)
    for i, (_, c) in enumerate(items):
        caps[i, :lengths[i]] = c[:max_caption_len]
    return {"video": vids, "captions": caps, "lengths": lengths}


class Loader:
    """Shuffling epoch iterator; worker threads decode num_workers + 1 batches
    ahead of the consumer (:220-281). Yields host numpy batches."""

    def __init__(self, dataset, batch_size=64, shuffle=True, num_workers=4,
                 max_caption_len=32, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.max_caption_len = max_caption_len
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        """Whole batches only (the last partial batch is dropped)."""
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        slices = [order[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            ahead = self.num_workers + 1
            futs = [ex.submit(self._load, s) for s in slices[:ahead]]
            for s in slices[ahead:]:
                nxt = ex.submit(self._load, s)
                yield futs.pop(0).result()
                futs.append(nxt)
            for f in futs:
                yield f.result()

    def _load(self, idxs):
        return collate([self.dataset[int(i)] for i in idxs], self.max_caption_len)


class BatchLoader(Loader):
    """Loader over a batch-level dataset, one that assembles whole batches
    itself (`get_batch(idxs, max_caption_len) -> batch dict`, the packed
    frame cache; :284-323). The same seed gives the JAX package's batch
    order."""

    def _load(self, idxs):
        return self.dataset.get_batch(idxs, self.max_caption_len)


def my_dataset(data=None, vocab=None, anno=None, transform=None, random_frames=0,
               num_frames=16, frame_size=None, num_channels=3, normalize=True, **_):
    """The video dataset factory of the config surface (:329-334)."""
    return VideoDataset(video_dir=data, vocab=vocab, captions=anno, num_frames=num_frames,
                        frame_size=frame_size, num_channels=num_channels,
                        random_frames=random_frames, normalize=normalize)


def cifar10_dataset(data=None, vocab=None, anno=None, transform=None, frame_size=None,
                    num_channels=3, **_):
    """The CIFAR-10 image dataset of config/cifar10.json (:337-340), from the
    local `cifar-10-batches-py` pickles (data/cifar10.py)."""
    from txt2vid_tpu_torch.data.cifar10 import Cifar10Dataset
    return Cifar10Dataset(data, frame_size=frame_size, num_channels=num_channels)


class ShardedView:
    """One rank's share of a dataset for data-parallel feeding
    (data/__init__.py:343-376): local item i is global item
    i * num_shards + shard (strided, so every rank sees the same label and
    length distribution), the ragged tail dropped so every rank runs the
    same number of batches per epoch (a short rank would hang the others'
    collectives). Item-level datasets (__getitem__) and batch-level ones
    (.get_batch) both work; other attributes are the base dataset's."""

    def __init__(self, dataset, shard: int, num_shards: int):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        self.dataset = dataset
        self.shard = shard
        self.num_shards = num_shards

    def __len__(self):
        return len(self.dataset) // self.num_shards

    def _global(self, i):
        return int(i) * self.num_shards + self.shard

    def __getitem__(self, i):
        return self.dataset[self._global(i)]

    def __getattr__(self, name):
        # get_batch exists only when the base dataset has one (get_loader
        # picks BatchLoader by hasattr)
        attr = getattr(self.dataset, name)
        if name == "get_batch":
            def wrapped(idxs, *a, **kw):
                return attr(np.asarray([self._global(i) for i in idxs]), *a, **kw)
            return wrapped
        return attr


def get_loader(dset=None, batch_size=64, val=False, num_workers=4, max_caption_len=32,
               seed=0):
    """A Loader over `dset`, or a BatchLoader where it is batch-level
    (`get_batch`), shuffled unless `val` (:379-387)."""
    if hasattr(dset, "get_batch"):
        return BatchLoader(dset, batch_size=batch_size, shuffle=not val,
                           num_workers=num_workers, max_caption_len=max_caption_len,
                           seed=seed)
    return Loader(dset, batch_size=batch_size, shuffle=not val, num_workers=num_workers,
                  max_caption_len=max_caption_len, seed=seed)


def main(args):
    """Vocab-build CLI: `python -m txt2vid_tpu_torch.data --sents S --out V`."""
    ex_to_sent = load_pickle(args.sents)
    sentences = [s for x in ex_to_sent for s in ex_to_sent[x]]
    vocab = build_vocab(sentences)
    print(f"vocab size: {len(vocab)}")
    with open(args.out, "wb") as f:
        pickle.dump(vocab, f)


def build_parser():
    import argparse
    parser = argparse.ArgumentParser(description="Build a caption vocabulary pickle.")
    parser.add_argument("--sents", type=str, required=True,
                        help="sentence pickle {key: [sentences]}")
    parser.add_argument("--out", type=str, required=True, help="output vocab pickle")
    return parser
