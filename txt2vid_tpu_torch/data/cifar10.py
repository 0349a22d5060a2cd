"""CIFAR-10 images from the local python-format batches (counterpart of
txt2vid_tpu/data/cifar10.py): reads the `cifar-10-batches-py` pickles
directly, with no download and no torchvision. Each item is one (H, W, C)
image in [-1, 1] (data.transform_frames: centre crop or zero padding to
frame_size, the channel policy) and no caption, for --img_model
--data_is_imgs."""

import pickle
from pathlib import Path

import numpy as np

from txt2vid_tpu_torch.data import transform_frames


class Cifar10Dataset:
    def __init__(self, data_dir, train=True, frame_size=None, num_channels=3):
        root = Path(data_dir)
        if (root / "cifar-10-batches-py").exists():
            root = root / "cifar-10-batches-py"
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        xs = []
        for n in names:
            if not (root / n).exists():
                continue
            with open(root / n, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], dtype=np.uint8))
        if not xs:
            raise FileNotFoundError(f"no CIFAR-10 batches under {root}")
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.frame_size = frame_size
        self.num_channels = num_channels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = transform_frames(self.images[idx][None], self.frame_size, self.num_channels)
        return img[0], None
