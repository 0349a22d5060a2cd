"""The weights both sides run, made by the benchmark from the seed.

Every leaf of a model comes from one `torch.randn` over all of them on the
device (a seeded `torch.Generator` there), scaled per leaf by its init kind
in one multiply-add: N(0, std) or a constant. The names and kinds are the
plain reference's (`reference.models.init_kinds`), which are the program's
state-dict names, so the same tensors load into the program and into the
reference.
"""

import numpy as np
import torch


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed from `seed` and a path of small integers."""
    state = np.random.SeedSequence([int(seed), *path]).generate_state(2, dtype=np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def make(kinds: dict, shapes: dict, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every leaf in `kinds`."""
    names = list(kinds)
    numels = [int(np.prod(shapes[n], dtype=np.int64)) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    counts = torch.tensor(numels, device=device)
    std = torch.tensor([k[1] if k[0] == "normal" else 0.0 for k in (kinds[n] for n in names)],
                       device=device).repeat_interleave(counts)
    const = torch.tensor([k[1] if k[0] == "const" else 0.0 for k in (kinds[n] for n in names)],
                         device=device).repeat_interleave(counts)
    flat = torch.addcmul(const, flat, std)
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(numels))}


def model_weights(models: dict, seed: int, device) -> dict:
    """{prefix: reference module} -> {prefix.name: tensor} from one draw."""
    from portbench.reference.models import init_kinds
    kinds, shapes = {}, {}
    for prefix, module in models.items():
        state = module.state_dict()
        for name, kind in init_kinds(module).items():
            kinds[f"{prefix}.{name}"] = kind
            shapes[f"{prefix}.{name}"] = tuple(state[name].shape)
    return make(kinds, shapes, seed, device)


def part(weights: dict, prefix: str) -> dict:
    """The leaves under `prefix.`, with the prefix taken off."""
    cut = len(prefix) + 1
    return {k[cut:]: v for k, v in weights.items() if k.startswith(prefix + ".")}


@torch.no_grad()
def load(module: torch.nn.Module, leaves: dict) -> None:
    """Copy `leaves` into `module`'s parameters and buffers, which must be
    exactly those (BatchNorm's batch counter aside), of the same shapes."""
    state = {k: v for k, v in module.state_dict(keep_vars=True).items()
             if not k.endswith("num_batches_tracked")}
    if set(state) != set(leaves):
        missing, extra = sorted(set(state) - set(leaves)), sorted(set(leaves) - set(state))
        raise ValueError(f"weights do not fit the module: missing {missing[:8]}, "
                         f"extra {extra[:8]}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(leaves[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} against "
                             f"{tuple(leaves[name].shape)}")
        t.copy_(leaves[name])
