"""Packed frame cache (the port's copy of txt2vid_tpu/data/packed.py:64-290):
one mmap'd file of videos with a native (C++) batch reader and a numpy path.

`write_packed_cache` writes any (video_id, uint8 (T, H, W, C)) sequence, and
`pack_directory` a directory of `<vid>.npy` clips, into one "T2VC1" file with
a `.ids.pickle` sidecar mapping video ids to indices; either package reads
the file the other wrote. `PackedVideoDataset` assembles whole batches
(`get_batch`) with the C++ thread pool of txt2vid_tpu_torch/native/
framecache.cpp, which g++ builds on first use into build/txt2vid_tpu_torch/
keyed by a hash of the source and flags, and ctypes binds. Where it cannot be
built or opened the reader takes the numpy path, with a warning, as the JAX
package does; `PackedReader.native` says which one is in use.

    python -m txt2vid_tpu_torch.data.packed --dir VIDEOS --out FILE.t2vc
"""

import ctypes
import functools
import hashlib
import os
import pickle
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.data import encode_caption, pick_frames, transform_frames
from txt2vid_tpu_torch.ops._build import BUILD_DIR
from txt2vid_tpu_torch.utils import status, warn

MAGIC = 0x0000314356325400  # "\0T2VC1\0\0" little-endian

NATIVE_SOURCE = Path(__file__).resolve().parents[1] / "native" / "framecache.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared"]


def native_library_path() -> Path:
    key = hashlib.sha256(NATIVE_SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libframecache-{key.hexdigest()[:16]}.so"


def build_native() -> Path:
    """Compile framecache.cpp with g++ unless it is built; returns the library."""
    out = native_library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the native frame-cache reader")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} exited {res.returncode}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _load_native():
    """The C++ reader, built first if needed; None (with a warning) where it
    cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build_native()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        warn(f"native framecache unavailable, using the numpy path: {e}")
        return None
    lib.fc_open.restype = ctypes.c_void_p
    lib.fc_open.argtypes = [ctypes.c_char_p]
    lib.fc_close.restype = None
    lib.fc_close.argtypes = [ctypes.c_void_p]
    lib.fc_num_videos.restype = ctypes.c_int64
    lib.fc_num_videos.argtypes = [ctypes.c_void_p]
    lib.fc_video_shape.restype = ctypes.c_int
    lib.fc_video_shape.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.fc_read_batch.restype = ctypes.c_int
    lib.fc_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    return lib


def write_packed_cache(videos, out_path, ids_out_path=None):
    """videos: iterable of (video_id, uint8 array (T, H, W[, C])). Writes the
    packed file and, with ids_out_path, a pickle mapping video_id -> index."""
    id_map = {}
    entries, data = [], []
    offset = 0
    for i, (vid, arr) in enumerate(videos):
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        if arr.ndim == 3:
            arr = arr[..., None]
        t, h, w, c = arr.shape
        entries.append((offset, t, h, w, c))
        id_map[str(vid)] = i
        data.append(arr)
        offset += arr.nbytes
    header_size = 16 + len(entries) * (8 + 16)
    with open(out_path, "wb") as f:
        f.write(struct.pack("<QQ", MAGIC, len(entries)))
        for off, t, h, w, c in entries:
            f.write(struct.pack("<QIIII", header_size + off, t, h, w, c))
        for arr in data:
            f.write(arr.tobytes())
    if ids_out_path is not None:
        with open(ids_out_path, "wb") as f:
            pickle.dump(id_map, f)
    return id_map


def pack_directory(video_dir, out_path):
    """Pack a directory of `<vid>.npy` clips into one T2VC file, with the
    `<out>.ids.pickle` sidecar."""
    files = sorted(Path(video_dir).glob("*.npy"), key=lambda p: p.stem)
    return write_packed_cache(((p.stem, np.load(p)) for p in files), out_path,
                              str(Path(out_path).with_suffix(".ids.pickle")))


class PackedReader:
    """mmap'd reader over a T2VC file: the native batch gather when it is
    available (`native` True), the numpy path otherwise."""

    def __init__(self, path, num_threads: int = 8):
        self.path = str(path)
        self.num_threads = num_threads
        self._lib = _load_native()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.fc_open(self.path.encode())
            if not self._handle:
                warn(f"fc_open failed for {path}; using the numpy path")
                self._lib = None
        self.native = self._lib is not None
        if self.native:
            shape = (ctypes.c_int64 * 4)()
            self._lib.fc_video_shape(self._handle, 0, shape)
            self.frame_shape = tuple(int(x) for x in shape[1:])
            self.num_videos = int(self._lib.fc_num_videos(self._handle))
        else:
            self._np_open()

    def _np_open(self):
        with open(self.path, "rb") as f:
            magic, n = struct.unpack("<QQ", f.read(16))
            if magic != MAGIC:
                raise ValueError(f"{self.path} is not a T2VC1 file (magic {magic:#x})")
            metas = [struct.unpack("<QIIII", f.read(24)) for _ in range(n)]
        self._metas = metas
        self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        self.num_videos = n
        self.frame_shape = tuple(metas[0][2:5])

    def video_num_frames(self, idx: int) -> int:
        if self.native:
            shape = (ctypes.c_int64 * 4)()
            if self._lib.fc_video_shape(self._handle, idx, shape) != 0:
                raise IndexError(f"video {idx} of {self.num_videos}")
            return int(shape[0])
        return self._metas[idx][1]

    def read_batch(self, video_ids: np.ndarray, frame_idx: np.ndarray) -> np.ndarray:
        """(B,), (B, F) -> uint8 (B, F, H, W, C)."""
        b, fcount = frame_idx.shape
        h, w, c = self.frame_shape
        out = np.empty((b, fcount, h, w, c), dtype=np.uint8)
        if self.native:
            vids = np.ascontiguousarray(video_ids, dtype=np.int64)
            fidx = np.ascontiguousarray(frame_idx, dtype=np.int64)
            rc = self._lib.fc_read_batch(
                self._handle, vids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b, fcount,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self.num_threads)
            if rc != 0:
                raise RuntimeError(f"fc_read_batch failed rc={rc}")
            return out
        for i, vid in enumerate(video_ids):
            off, t, hh, ww, cc = self._metas[int(vid)]
            video = self._mmap[off:off + t * hh * ww * cc].reshape(t, hh, ww, cc)
            out[i] = video[frame_idx[i]]
        return out

    def close(self):
        if self.native and self._handle:
            self._lib.fc_close(self._handle)
            self._handle = None


class PackedVideoDataset:
    """Batch-level dataset over a packed cache and captions: a batch is one
    native gather and one vectorised transform (`get_batch`); `__getitem__`
    gives the per-item (video, encoded caption) of VideoDataset."""

    def __init__(self, packed_path, vocab=None, captions=None, num_frames=16,
                 frame_size=None, num_channels=3, num_threads=8, normalize=True,
                 random_frames=0, seed=0):
        self.reader = PackedReader(packed_path, num_threads=num_threads)
        self.vocab = vocab
        self.num_frames = num_frames
        self.frame_size = frame_size
        self.num_channels = num_channels
        self.normalize = normalize           # False keeps uint8 for the copy to the device
        self.random_frames = bool(random_frames)
        self.rng = np.random.default_rng(seed)
        # BatchLoader calls get_batch from several threads; numpy Generators
        # are not thread-safe, so frame-index draws take this lock
        self._rng_lock = threading.Lock()

        ids_path = Path(packed_path).with_suffix(".ids.pickle")
        id_map = None
        if ids_path.exists():
            with open(ids_path, "rb") as f:
                id_map = pickle.load(f)

        self.video_idx, self.captions = [], []
        if captions is not None:
            caps = captions
            if isinstance(captions, (str, Path)):
                with open(captions, "rb") as f:
                    caps = pickle.load(f)
            for vid in caps:
                key = str(vid)
                if id_map is not None and key not in id_map:
                    continue
                idx = id_map[key] if id_map is not None else int(key)
                for cap in caps[vid]:
                    self.video_idx.append(idx)
                    self.captions.append(cap)
        else:
            self.video_idx = list(range(self.reader.num_videos))
            self.captions = [None] * len(self.video_idx)

    def __len__(self):
        return len(self.video_idx)

    def _frames(self, vids):
        with self._rng_lock:
            return np.stack([pick_frames(self.reader.video_num_frames(int(v)), self.num_frames,
                                         random=self.random_frames, rng=self.rng)
                             for v in vids])

    def __getitem__(self, idx):
        vid = np.asarray([self.video_idx[idx]], np.int64)
        raw = self.reader.read_batch(vid, self._frames(vid))[0]
        frames = transform_frames(raw, self.frame_size, self.num_channels,
                                  normalize=self.normalize)
        caption = (encode_caption(self.vocab, self.captions[idx])
                   if self.vocab is not None and self.captions[idx] is not None else None)
        return frames, caption

    def get_batch(self, idxs, max_caption_len=32):
        vids = np.asarray([self.video_idx[i] for i in idxs], dtype=np.int64)
        raw = self.reader.read_batch(vids, self._frames(vids))
        b, t = raw.shape[:2]
        frames = transform_frames(raw.reshape((-1,) + raw.shape[2:]), self.frame_size,
                                  self.num_channels, normalize=self.normalize)
        batch = {"video": frames.reshape((b, t) + frames.shape[1:])}
        if self.vocab is not None and self.captions[0] is not None:
            caps = np.zeros((b, max_caption_len), np.int32)
            lengths = np.zeros((b,), np.int32)
            for i, j in enumerate(idxs):
                enc = encode_caption(self.vocab, self.captions[j])[:max_caption_len]
                caps[i, :len(enc)] = enc
                lengths[i] = len(enc)
            batch["captions"] = caps
            batch["lengths"] = lengths
        return batch


def packed_dataset(data=None, vocab=None, anno=None, num_frames=16, frame_size=None,
                   num_channels=3, normalize=True, random_frames=0, num_threads=8, **_):
    """The packed dataset factory of the config surface (`--data '{"class":
    "txt2vid_tpu.data.packed.packed_dataset", ...}'`); get_loader hands
    batch-level datasets to BatchLoader."""
    return PackedVideoDataset(data, vocab=vocab, captions=anno, num_frames=num_frames,
                              frame_size=frame_size, num_channels=num_channels,
                              normalize=normalize, random_frames=random_frames,
                              num_threads=num_threads)


def build_parser():
    import argparse
    parser = argparse.ArgumentParser(
        description="Pack a directory of per-video .npy caches into one T2VC file")
    parser.add_argument("--dir", required=True, help="directory of <vid>.npy caches")
    parser.add_argument("--out", required=True, help="output .t2vc path")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    status(f"packed {len(pack_directory(args.dir, args.out))} videos -> {args.out}")
