"""Video files of generated clips (counterpart of txt2vid_tpu/utils/video.py).

  * .gif  - written here with the standard library (the port does not use
            PIL): LZW-coded frames, a NETSCAPE2.0 block that loops forever,
            and each frame's delay of max(int(1000 / fps), 1) ms stored in
            centiseconds, truncated, as PIL stores it. A frame equal to the
            one before it adds its milliseconds to that frame's instead, as
            PIL's writer merges them. Luma clips (C = 1, what both flagships'
            scripts train) use a palette of the 256 grays and decode bit for
            bit; an RGB clip whose channels agree is written as luma. Other
            RGB clips use the fixed 6x6x6 color cube (levels 0, 51, ..., 255):
            each channel rounds to the nearest level, at most RGB_MAX_ERROR
            off.
  * .avi / .mp4 / .webm - cv2's VideoWriter where OpenCV is installed (XVID,
            mp4v, VP80); where it is not, an ImportError that names .gif.

Used by sample.py and serve.py through --format. Host-side only.
"""

import os

import numpy as np

VIDEO_EXTS = (".gif", ".avi", ".mp4", ".webm")

_FOURCC = {".avi": "XVID", ".mp4": "mp4v", ".webm": "VP80"}

# the RGB palette's levels per channel, and the largest error of a channel
_CUBE_STEP = 51
RGB_MAX_ERROR = _CUBE_STEP // 2


def to_uint8_frames(video: np.ndarray) -> np.ndarray:
    """(T, H, W, C) float [-1, 1] or uint8 -> (T, H, W, C) uint8."""
    v = np.asarray(video)
    if v.ndim == 3:                       # (T, H, W) grayscale
        v = v[..., None]
    assert v.ndim == 4, f"expected (T, H, W, C), got {v.shape}"
    if v.dtype != np.uint8:
        v = ((np.clip(v, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)
    return v


def _lzw(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-length LZW code of a frame's palette indices, packed
    least significant bit first."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    size = min_code_size + 1
    table, next_code = {}, eoi + 1
    emit(clear)
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            if next_code == 1 << size:
                size += 1
            next_code += 1
        else:
            emit(clear)
            table, next_code, size = {}, eoi + 1, min_code_size + 1
        prefix = c
    emit(prefix)
    # the decoder adds an entry for the last code before it reads the end code
    if next_code == 1 << size and size < 12:
        size += 1
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _palette(v: np.ndarray):
    """(frames as palette indices (T, H, W) uint8, the 256-entry RGB palette)."""
    if v.shape[-1] == 1 or (np.array_equal(v[..., 0], v[..., 1])
                            and np.array_equal(v[..., 0], v[..., 2])):
        return v[..., 0], np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    levels = (v.astype(np.int32) + _CUBE_STEP // 2) // _CUBE_STEP      # 0..5
    idx = (levels[..., 0] * 36 + levels[..., 1] * 6 + levels[..., 2]).astype(np.uint8)
    cube = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[:216] = cube * _CUBE_STEP
    return idx, palette


def gif_bytes(video, fps: int = 8) -> bytes:
    """One clip, (T, H, W, C) in [-1, 1] float or uint8, as a looping GIF."""
    v = to_uint8_frames(video)
    if v.shape[-1] not in (1, 3):
        raise ValueError(f"a GIF holds luma or RGB frames, not {v.shape[-1]} channels")
    frames, palette = _palette(v)
    h, w = frames.shape[1:]
    ms = max(int(1000 / fps), 1)
    runs = []                                    # [frame, milliseconds]
    for f in frames:
        if runs and np.array_equal(runs[-1][0], f):
            runs[-1][1] += ms
        else:
            runs.append([f, ms])
    out = [b"GIF89a", w.to_bytes(2, "little"), h.to_bytes(2, "little"),
           bytes([0xF7, 0, 0]), palette.tobytes(),
           b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for k, (f, ms) in enumerate(runs):
        if k or ms >= 10:        # as PIL: none before a first frame of no delay
            out += [b"\x21\xF9\x04\x00", min(ms // 10, 0xFFFF).to_bytes(2, "little"),
                    b"\x00\x00"]
        out += [b"\x2C\x00\x00\x00\x00", w.to_bytes(2, "little"), h.to_bytes(2, "little"),
                b"\x00\x08", _sub_blocks(_lzw(f.tobytes()))]
    out.append(b"\x3B")
    return b"".join(out)


def save_video(video: np.ndarray, path: str, fps: int = 8) -> str:
    """Write one clip - (T, H, W, C) in [-1, 1] float or uint8 - to `path`,
    the container chosen by the extension (VIDEO_EXTS)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gif":
        with open(path, "wb") as f:
            f.write(gif_bytes(video, fps))
        return path
    if ext in _FOURCC:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"writing {ext} requires OpenCV (cv2); use .gif instead") from e
        v = to_uint8_frames(video)
        h, w = v.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*_FOURCC[ext]), fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2.VideoWriter could not open {path} ({_FOURCC[ext]})")
        try:
            for f in v:
                if f.shape[-1] == 1:
                    f = np.repeat(f, 3, axis=-1)
                writer.write(np.ascontiguousarray(f[..., ::-1]))          # RGB -> BGR
        finally:
            writer.release()
        return path
    raise ValueError(f"unsupported video extension {ext!r} (one of {', '.join(VIDEO_EXTS)})")


def save_video_batch(videos: np.ndarray, path_fmt: str, fps: int = 8):
    """Write a batch - (B, T, H, W, C) - one file per clip; `path_fmt` is a
    format string with one `{i}` field. Returns the written paths."""
    return [save_video(v, path_fmt.format(i=i), fps=fps)
            for i, v in enumerate(np.asarray(videos))]
