"""Frame-cache builder (counterpart of txt2vid_tpu/data/cache.py): decode
source videos with OpenCV, keep `num_frames` evenly spaced frames, resize them
square and write each clip as `<stem>.npy` uint8 (T, H, W, 3), the layout
VideoDataset reads.

    python -m txt2vid_tpu_torch.data.cache --videos RAW --out CLIPS \\
        [--size 64] [--num_frames 16] [--workers 8]

cv2 is an optional host dependency, imported where a video is decoded:
without it every clip counts as failed. The workers are spawned processes
(fork is unsafe in a process that already runs threads); this module imports
neither torch nor cv2 when it is imported, so they start quickly.
"""

import multiprocessing as mp
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.data import pick_frames
from txt2vid_tpu_torch.utils.misc import ensure_exists

VIDEO_SUFFIXES = (".avi", ".mp4", ".gif", ".webm", ".mkv")


def decode_video(path, size: int | None = None) -> np.ndarray | None:
    """Every frame as uint8 (T, H, W, 3) RGB, each resized to (size, size);
    None when cv2 is missing or no frame decodes."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if size is not None:
                frame = cv2.resize(frame, (size, size))
            frames.append(frame)
    finally:
        cap.release()
    return np.stack(frames) if frames else None


def cache_one(args) -> tuple[str, bool]:
    """(stem, cached): one video -> `<out_dir>/<stem>.npy`. An existing file
    is kept; a clip of at least num_frames frames keeps num_frames evenly
    spaced ones, a shorter one all of its frames."""
    src, out_dir, size, num_frames = args
    src = Path(src)
    out = Path(out_dir) / (src.stem + ".npy")
    if out.exists():
        return src.stem, True
    frames = decode_video(src, size)
    if frames is None:
        return src.stem, False
    if num_frames is not None and len(frames) >= num_frames:
        frames = frames[pick_frames(len(frames), num_frames)]
    np.save(out, frames)
    return src.stem, True


def build_cache(video_dir, out_dir, size=64, num_frames=16, workers=8):
    """Cache every video directly under video_dir (VIDEO_SUFFIXES, any case)
    into out_dir with a pool of `workers` processes; returns [(stem,
    cached)] in the order of the directory listing."""
    ensure_exists(out_dir)
    srcs = [p for p in Path(video_dir).iterdir() if p.suffix.lower() in VIDEO_SUFFIXES]
    jobs = [(str(p), str(out_dir), size, num_frames) for p in srcs]
    with mp.get_context("spawn").Pool(workers) as pool:
        results = pool.map(cache_one, jobs)
    ok = sum(1 for _, s in results if s)
    print(f"cached {ok}/{len(results)} videos -> {out_dir}")
    return results


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="Cache videos as <stem>.npy uint8 clips.")
    p.add_argument("--videos", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--workers", type=int, default=8)
    a = p.parse_args()
    build_cache(a.videos, a.out, a.size, a.num_frames, a.workers)
