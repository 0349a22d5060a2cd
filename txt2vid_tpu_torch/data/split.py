"""Train/validation split of a clip directory (counterpart of
txt2vid_tpu/data/split.py): the entries, sorted by name and shuffled with
Python's random.Random(seed), the first train_frac of them copied to the
train directory and the rest to the validation one (frame directories
whole).

    python -m txt2vid_tpu_torch.data.split --src CLIPS --train TRAIN --val VAL
"""

import random
import shutil
from pathlib import Path

from txt2vid_tpu_torch.utils.misc import ensure_exists


def split(src_dir, train_dir, val_dir, train_frac=0.8, seed=0) -> tuple[int, int]:
    """(train count, validation count)."""
    files = sorted(Path(src_dir).iterdir())
    random.Random(seed).shuffle(files)
    n_train = int(len(files) * train_frac)
    ensure_exists(train_dir)
    ensure_exists(val_dir)
    for i, f in enumerate(files):
        dst = Path(train_dir if i < n_train else val_dir) / f.name
        if f.is_dir():
            shutil.copytree(f, dst, dirs_exist_ok=True)
        else:
            shutil.copy(f, dst)
    return n_train, len(files) - n_train


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description="Copy a clip directory 80/20.")
    p.add_argument("--src", required=True)
    p.add_argument("--train", required=True)
    p.add_argument("--val", required=True)
    a = p.parse_args()
    print(split(a.src, a.train, a.val))
