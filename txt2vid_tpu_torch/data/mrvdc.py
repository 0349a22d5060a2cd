"""MSR Video Description Corpus captions (counterpart of
txt2vid_tpu/data/mrvdc.py): MSR.csv -> a {clip key: [descriptions]} pickle.

Keeps English descriptions of at most MAX_DESC_LEN characters, keys each clip
`<VideoID>_<Start>_<End>`, and with --videos drops clips that have no file
there (counted and reported) and clips that OpenCV counts fewer than
MIN_FRAMES frames in.

    python -m txt2vid_tpu_torch.data.mrvdc --csv MSR.csv [--videos RAW] --out sent.pickle

pandas (reading the csv) and cv2 (the frame count) are optional host
dependencies, imported where they are used; without cv2 no clip is dropped
for its length.
"""

import pickle
from pathlib import Path

MAX_DESC_LEN = 60
MIN_FRAMES = 32


def probe_num_frames(path) -> int | None:
    """OpenCV's frame count of a video; None without cv2 or a count."""
    try:
        import cv2
    except ImportError:
        return None
    cap = cv2.VideoCapture(str(path))
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return n if n > 0 else None


def read_csv(csv_path, video_dir=None, check_frames=True) -> dict:
    """{`<VideoID>_<Start>_<End>`: [descriptions]} in the csv's row order."""
    import pandas as pd
    df = pd.read_csv(csv_path, encoding="utf-8", on_bad_lines="skip")
    df = df[df["Language"] == "English"]

    result = {}
    missing = 0
    for _, row in df.iterrows():
        desc = str(row["Description"]).strip()
        if len(desc) > MAX_DESC_LEN:
            continue
        key = f"{row['VideoID']}_{row['Start']}_{row['End']}"
        if video_dir is not None:
            candidates = list(Path(video_dir).glob(key + ".*"))
            if not candidates:
                missing += 1
                continue
            if check_frames:
                n = probe_num_frames(candidates[0])
                if n is not None and n < MIN_FRAMES:
                    continue
        result.setdefault(key, []).append(desc)
    if missing:
        print(f"missing {missing} clips")
    return result


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="MSR.csv -> a captions pickle.")
    p.add_argument("--csv", required=True)
    p.add_argument("--videos", default=None)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    data = read_csv(a.csv, a.videos)
    print(f"{len(data)} clips")
    with open(a.out, "wb") as f:
        pickle.dump(data, f)
