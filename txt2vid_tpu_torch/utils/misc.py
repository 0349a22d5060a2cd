"""Small helpers (the port's own copies of txt2vid_tpu/utils/misc.py's).
torch is imported where it is used, so that the host tools that import
these helpers start without it."""

from __future__ import annotations

from pathlib import Path


def ensure_exists(path) -> None:
    """mkdir -p (misc.py:69-71)."""
    Path(path).mkdir(parents=True, exist_ok=True)


def count_params(module: torch.nn.Module) -> int:
    """Total number of scalars in a module's parameters (misc.py:41-43)."""
    return sum(p.numel() for p in module.parameters())


def gen_perm_device(n: int, p=None, generator: torch.Generator | None = None) -> torch.Tensor:
    """A uniformly random n-cycle, the mismatched-caption derangement
    (misc.py:24-38): perm[p[i]] = p[(i + 1) % n] for a permutation p, given or
    drawn from `generator`. Every n-cycle moves every element. n <= 1 has no
    derangement; the identity is returned. Returns int64 on p's device (the
    CPU when drawn)."""
    import torch
    if n <= 1:
        return torch.arange(n)
    if p is None:
        p = torch.randperm(n, generator=generator)
    p = torch.as_tensor(p, dtype=torch.long)
    perm = torch.empty_like(p)
    perm[p] = p.roll(-1)
    return perm
