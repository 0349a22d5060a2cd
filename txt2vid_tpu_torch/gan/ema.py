"""Exponential moving average of the generator's parameters (``--g_ema``;
counterpart of txt2vid_tpu/gan/ema.py:37-89).

The average is a dict name -> tensor over the generator's parameters, kept
outside the train step (the step is the same with EMA on or off) and updated
after it with one fused lerp, ema += (1 - decay) * (params - ema). It is saved
beside each checkpoint as ``<checkpoint>.ema``, a msgpack file of the
generator's flax params tree, so either package reads the other's; a
checkpoint without one restarts the average from the restored parameters.

With --steps_per_dispatch k the trainer updates the average once per chunk
of k steps with decay**k (ema.py:37-51): the k - 1 iterates inside a chunk
are skipped.
"""

import copy
import os

import torch

from txt2vid_tpu_torch.convert import (jax_to_torch_generator, torch_to_jax_generator,
                                       vars_to_jax, vars_to_torch)
from txt2vid_tpu_torch.utils.checkpoint import restore_state, save_state


def make_ema_update(decay: float, steps_per_dispatch: int = 1):
    """update(ema, generator): ema <- ema + (1 - decay**k) * (params - ema), in
    place, k = steps_per_dispatch."""
    weight = 1.0 - float(decay) ** int(steps_per_dispatch)

    @torch.no_grad()
    def update(ema: dict, gen: torch.nn.Module) -> dict:
        params = dict(gen.named_parameters())
        torch._foreach_lerp_(list(ema.values()), [params[n] for n in ema], weight)
        return ema

    return update


def init_ema(gen: torch.nn.Module) -> dict:
    """A copy (not an alias) of the generator's parameters."""
    return {n: p.detach().clone() for n, p in gen.named_parameters()}


def ema_path(checkpoint_path) -> str:
    return str(checkpoint_path) + ".ema"


def ema_tree(ema: dict, gen: torch.nn.Module | None = None) -> dict:
    """The EMA as the generator's flax params tree (what the JAX package
    saves); `gen` names the generator it averages (default a TGANv2
    MultiScaleGen)."""
    if gen is None:
        return torch_to_jax_generator(ema)[0]
    return vars_to_jax(gen, ema)[0]


def save_ema(ema: dict, checkpoint_path, gen: torch.nn.Module | None = None) -> str:
    return save_state(ema_tree(ema, gen), ema_path(checkpoint_path))


def load_ema(checkpoint_path, template: dict, gen: torch.nn.Module | None = None):
    """The sibling ``.ema`` average of a checkpoint, as tensors like `template`
    (an EMA dict, or the generator's named parameters), or None when the
    checkpoint has none; `gen` as in ema_tree."""
    path = ema_path(checkpoint_path)
    if not os.path.exists(path):
        return None
    tree = restore_state(ema_tree(template, gen), path)
    params = jax_to_torch_generator(tree) if gen is None else vars_to_torch(gen, tree)
    return {n: params[n].to(template[n].device, template[n].dtype) for n in template}


@torch.no_grad()
def with_ema_params(gen: torch.nn.Module, ema: dict) -> torch.nn.Module:
    """A copy of the generator with the EMA parameters in it, for sampling;
    the live generator is untouched (its BatchNorm statistics are shared by
    value, as JAX's with_ema_params keeps batch_stats)."""
    out = copy.deepcopy(gen)
    for n, p in out.named_parameters():
        p.copy_(ema[n])
    return out
