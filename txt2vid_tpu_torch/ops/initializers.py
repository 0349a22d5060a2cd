"""Weight initializers with the JAX package's semantics
(counterpart of txt2vid_tpu/ops/initializers.py).

The JAX package builds every Linear/Conv/Embedding kernel xavier-normal (with a
sqrt(2) gain inside residual paths) and zeros every bias; fused multi-gate
kernels take their fan per gate; flax's LSTM cells keep flax's own defaults
(lecun-normal input kernels, orthogonal recurrent kernels, zero biases). Here
each module applies that policy to its own parameters in `init_weights(gen)`,
and `init_from_seed` walks a model with one seeded `torch.Generator`, so a model
is reproducible from a seed without JAX. The draws are not the JAX draws: the
distributions match, the numbers do not.

`init_method` ("xavier", "ortho" or "normal", make_kernel_init's choices)
selects the kernel initializer: `kernel_init_` draws with the one that
`init_from_seed(..., method=)` makes active.
"""

import contextvars
import math

import torch

RESIDUAL_GAIN = math.sqrt(2.0)

# std of a standard normal truncated to [-2, 2] (flax's truncated_normal fix-up)
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor):
    """(fan_in, fan_out) of a torch weight (out, in, *kernel)."""
    receptive = math.prod(w.shape[2:])
    return w.shape[1] * receptive, w.shape[0] * receptive


@torch.no_grad()
def xavier_normal_(w, gain: float = 1.0, generator=None):
    """N(0, gain * sqrt(2 / (fan_in + fan_out))) — variance_scaling(gain^2,
    fan_avg, normal)."""
    fan_in, fan_out = _fans(w)
    return w.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)),
                     generator=generator)


INIT_METHODS = ("xavier", "ortho", "normal")
_METHOD = contextvars.ContextVar("txt2vid_init_method", default="xavier")


@torch.no_grad()
def kernel_init_(w, gain: float = 1.0, generator=None):
    """The active init method's kernel initializer (make_kernel_init):
    xavier-normal, orthogonal times gain, or N(0, 0.02 * gain)."""
    method = _METHOD.get()
    if method == "xavier":
        return xavier_normal_(w, gain, generator)
    if method == "ortho":
        return torch.nn.init.orthogonal_(w, gain=gain, generator=generator)
    return w.normal_(0.0, 0.02 * gain, generator=generator)


@torch.no_grad()
def fused_gate_xavier_(w, num_gates: int = 4, gain: float = 1.0, generator=None):
    """A fused (num_gates*C, in, ...) kernel initialized as num_gates separate
    (C, in, ...) kernels, so each gate's fan_out is C (fused_gate_init)."""
    for part in w.chunk(num_gates, dim=0):
        kernel_init_(part, gain, generator)
    return w


@torch.no_grad()
def lecun_normal_(w, generator=None):
    """flax lecun_normal: truncated normal with variance 1/fan_in."""
    std = math.sqrt(1.0 / _fans(w)[0]) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


@torch.no_grad()
def orthogonal_(w, generator=None):
    return torch.nn.init.orthogonal_(w, generator=generator)


def init_from_seed(model: torch.nn.Module, seed: int,
                   method: str | None = None) -> torch.nn.Module:
    """Initialize every submodule that defines `init_weights(generator)` from one
    CPU generator seeded with `seed`, in module order, kernels by `method`
    (default: the model's `init_method` attribute, else xavier)."""
    method = method or getattr(model, "init_method", "xavier")
    if method not in INIT_METHODS:
        raise ValueError(f"unknown init method: {method}")
    gen = torch.Generator().manual_seed(seed)
    token = _METHOD.set(method)
    try:
        for m in model.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
    finally:
        _METHOD.reset(token)
    return model
