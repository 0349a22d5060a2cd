"""Device-resident dataset (counterpart of txt2vid_tpu/data/device_cache.py):
a packed video cache uploaded to the card once, each step's batch assembled
there from the drawn indices.

Per step only the B drawn indices cross to the device: the clips, the
pair->video map and the caption matrix live there as uint8 and int64
tensors, and `assemble` gathers the batch with them. The caption lengths stay
on the host (the encoder's packing reads them there) and are indexed there.

Semantics, as the JAX package's (device_cache.py:20-29):
- pairs are drawn i.i.d. uniform with replacement, one draw of B per step (an
  epoch is num_pairs // B draws), not an epoch-shuffled permutation;
- frames are picked on the evenly spaced grid (stride T // num_frames), with
  one random phase in [0, stride) per step when `random_phase`
  (--random_frames);
- the video stays uint8 and the train step normalises it.

The draws come from a CPU torch.Generator seeded from (seed, step, 0xda7a)
(`draw`), where JAX folds (step, 0xda7a) into its key; `assemble` takes them
as arguments, so a test can feed it JAX's own.
"""

import numpy as np
import torch

from txt2vid_tpu_torch.data import encode_caption, transform_frames

BATCH_SALT = 0xDA7A


class DeviceVideoData:
    """The uint8 clips (N, T, H, W, C), the pair->video map (P,) and, with
    captions, the caption matrix (P, L) and lengths (P,), on the host; one
    upload (`device_arrays`) and the batch assembly on the device."""

    def __init__(self, videos: np.ndarray, vid_idx: np.ndarray, captions, lengths,
                 num_frames: int, random_phase: bool = False):
        if videos.dtype != np.uint8 or videos.ndim != 5:
            raise ValueError(f"videos must be uint8 (N, T, H, W, C), not {videos.dtype} "
                             f"{videos.shape}")
        self.videos = videos
        self.vid_idx = np.asarray(vid_idx).astype(np.int32)
        self.captions = captions
        self.lengths = lengths
        self.num_frames = int(num_frames)
        self.random_phase = bool(random_phase)
        t = videos.shape[1]
        if self.num_frames > t:
            raise ValueError(f"num_frames {self.num_frames} > the cache's {t} frames")
        self.frame_stride = max(t // self.num_frames, 1)
        self._device = None

    @classmethod
    def from_packed(cls, packed_path, captions=None, vocab=None, max_caption_len: int = 32,
                    num_frames: int = 16, frame_size: int | None = None,
                    num_channels: int = 3, random_phase: bool = False):
        """Every clip of a uniform-shape packed cache (data/packed.py), at its
        final size and channels."""
        from txt2vid_tpu_torch.data.packed import PackedVideoDataset
        dset = PackedVideoDataset(packed_path, vocab=vocab, captions=captions,
                                  num_frames=num_frames, frame_size=frame_size,
                                  num_channels=num_channels, normalize=False)
        return cls.from_dataset(dset, max_caption_len=max_caption_len,
                                random_phase=random_phase)

    @classmethod
    def from_dataset(cls, dset, max_caption_len: int = 32, random_phase: bool = False):
        """From a PackedVideoDataset (the --data object): all its clips read
        whole through its reader and transformed once, its captions encoded
        and padded to max_caption_len."""
        reader = dset.reader
        n = reader.num_videos
        t0 = reader.video_num_frames(0)
        if any(reader.video_num_frames(i) != t0 for i in range(n)):
            raise ValueError("the device cache needs one frame count for every clip; "
                             "repack with a fixed T")
        raw = reader.read_batch(np.arange(n, dtype=np.int64),
                                np.arange(t0)[None].repeat(n, 0))
        vids = np.stack([transform_frames(v, dset.frame_size, dset.num_channels,
                                          normalize=False) for v in raw])
        caps = lens = None
        if dset.vocab is not None and dset.captions and dset.captions[0] is not None:
            p = len(dset.captions)
            caps = np.zeros((p, max_caption_len), np.int32)
            lens = np.zeros((p,), np.int32)
            for i, c in enumerate(dset.captions):
                enc = encode_caption(dset.vocab, c)[:max_caption_len]
                caps[i, :len(enc)] = enc
                lens[i] = len(enc)
        return cls(vids, np.asarray(dset.video_idx), caps, lens,
                   num_frames=dset.num_frames, random_phase=random_phase)

    @property
    def num_pairs(self) -> int:
        return len(self.vid_idx)

    @property
    def nbytes(self) -> int:
        """The bytes the upload puts on the device."""
        return sum(int(a.nbytes) for k, a in self.device_arrays().items()
                   if k != "lengths")

    def device_arrays(self, device=None) -> dict:
        """The clips, the pair->video map and the caption matrix on `device`,
        uploaded on the first call and kept; the lengths stay a host tensor."""
        if self._device is None:
            if device is None:
                raise ValueError("the first device_arrays call names the device")
            d = {"videos": torch.from_numpy(self.videos).to(device),
                 "vid_idx": torch.from_numpy(self.vid_idx).long().to(device)}
            if self.captions is not None:
                d["captions"] = torch.from_numpy(self.captions).long().to(device)
                d["lengths"] = torch.from_numpy(self.lengths)
            self._device = d
        return self._device

    def draw(self, seed: int, step: int, batch_size: int):
        """(pair indices (B,) int64, frame phase) of step `step`, from a CPU
        generator seeded from (seed, step, 0xda7a)."""
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence([seed, step, BATCH_SALT])
                            .generate_state(1)[0]))
        idx = torch.randint(0, self.num_pairs, (batch_size,), generator=gen)
        phase = (int(torch.randint(0, self.frame_stride, (), generator=gen))
                 if self.random_phase else 0)
        return idx, phase

    def assemble(self, idx, phase: int = 0) -> dict:
        """The batch of pairs `idx` (B,) with frames phase, phase + stride, ...
        gathered on the device: "video" uint8 (B, num_frames, H, W, C) and,
        with captions, "captions" (B, L) int64 on the device and "lengths"
        on the host."""
        arrays = self.device_arrays()
        dev = arrays["videos"].device
        idx_host = torch.as_tensor(idx, dtype=torch.int64).cpu()
        idx_dev = idx_host.to(dev, non_blocking=True)
        frames = torch.arange(self.num_frames, device=dev) * self.frame_stride + phase
        rows = arrays["vid_idx"][idx_dev]
        batch = {"video": arrays["videos"][rows[:, None], frames[None, :]]}
        if "captions" in arrays:
            batch["captions"] = arrays["captions"][idx_dev]
            batch["lengths"] = arrays["lengths"][idx_host]
        return batch

    def host_batch(self, idxs) -> dict:
        """A numpy batch of pairs `idxs` (modulo num_pairs) on the grid's
        first phase: the template batch and the real-sample grids."""
        idxs = np.asarray(idxs) % self.num_pairs
        vids = self.videos[self.vid_idx[idxs]]
        if self.num_frames < vids.shape[1]:
            vids = vids[:, np.arange(self.num_frames) * self.frame_stride]
        batch = {"video": vids}
        if self.captions is not None:
            batch["captions"] = self.captions[idxs]
            batch["lengths"] = self.lengths[idxs]
        return batch


class DeviceDataStep:
    """A train step that ignores the batch it is given and runs the wrapped
    TrainStep on the batch it assembles from `data` at its step counter
    (JAX's jit_device_data_step). Every other attribute is the wrapped
    step's."""

    def __init__(self, step, data: DeviceVideoData, batch_size: int, seed: int = 0):
        self.inner, self.data, self.batch_size, self.seed = step, data, batch_size, seed

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def batch(self) -> dict:
        """The batch of the wrapped step's next step."""
        return self.data.assemble(*self.data.draw(self.seed, self.inner.step,
                                                  self.batch_size))

    def __call__(self, _host_batch=None, draws=None):
        return self.inner(self.batch(), draws)


class DeviceEpochIterator:
    """The trainer's dataset under --device_data: an epoch of
    max(num_pairs // batch_size, 1) items, rotating through up to `rotate`
    host batches drawn with np.random.default_rng(seed) (the real-sample
    grids and caption dumps read them; the step assembles its own). `put`,
    when given, moves each of those batches to the device once."""

    def __init__(self, data: DeviceVideoData, batch_size: int, seed: int = 0,
                 rotate: int = 4, put=None):
        self._len = max(data.num_pairs // batch_size, 1)
        rng = np.random.default_rng(seed)
        self._host = [data.host_batch(rng.integers(0, data.num_pairs, batch_size))
                      for _ in range(min(rotate, self._len))]
        if put is not None:
            self._host = [put(b) for b in self._host]

    def __len__(self):
        return self._len

    def __iter__(self):
        for i in range(self._len):
            yield self._host[i % len(self._host)]
