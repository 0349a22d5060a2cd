"""Captions of the synthetic moving-digit dataset (the sentence pattern of
txt2vid_tpu/data/synthetic.py:104-119), for building a vocabulary and serving
requests without a dataset on disk."""

import numpy as np

_MOTIONS = ("left and right", "right and left", "top and bottom", "bottom and top")


def moving_digit_captions(n: int, seed: int = 0) -> list[str]:
    """n captions "digit D is MOTION." drawn from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [f"digit {int(rng.integers(0, 10))} is "
            f"{_MOTIONS[int(rng.integers(0, len(_MOTIONS)))]}." for _ in range(n)]
