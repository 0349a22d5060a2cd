"""Run setup: seeding and the device report (counterpart of
txt2vid_tpu/train/setup.py:57-72)."""

import random

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.utils import status


def set_seed(seed=None) -> int:
    """Seed Python's, numpy's and torch's generators; a random seed if None."""
    if seed is None:
        seed = random.randint(0, 2 ** 31 - 1)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return seed


def setup(args):
    """(seed, device): seeds from --seed, the device from --device (CUDA unless
    the caller asks for another; raises without a GPU), reported with the
    card's name; --debug_nans turns on autograd's anomaly detection (the
    counterpart of jax_debug_nans). Float32 matmuls and convolutions run in
    float32, not TF32 (the JAX package's semantics; cuDNN takes TF32 by
    default), as bench.py and serve.py hold them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = set_seed(getattr(args, "seed", None))
    status(f"seed: {seed}")
    device = resolve_device(getattr(args, "device", None))
    if device.type == "cuda":
        status(f"{torch.cuda.device_count()} cuda device(s) available; using "
               f"{torch.cuda.get_device_name(device)}")
    else:
        status(f"running on {device}")
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    return seed, device
