"""The precision the plain reference computes its products in.

"f32" is plain float32 (TF32 off). The two lower settings stand in for the
step a program could take below its stated precision, and serve as the
comparison's control: "tf32" rounds every operand of a convolution, a
dense layer or an attention product to TF32's 10-bit mantissa (what the
tensor cores do with allow_tf32), "fp8" scales each operand per tensor into
float8 e4m3 (gradients e5m2) and back. Both round the forward's operands and
the gradients that reach them, and both run on any device.
"""

import contextlib
import contextvars

import torch

_PRECISION = contextvars.ContextVar("portbench_precision", default="f32")
PRECISIONS = ("f32", "tf32", "fp8")

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def precision(name: str):
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} is not one of {PRECISIONS}")
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


def current() -> str:
    return _PRECISION.get()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties to even."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0x0FFF + keep) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Per-tensor scaled float8 round trip."""
    dtype, top = _FP8[fmt]
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def _round(x, name, grad):
    if name == "tf32":
        return round_tf32(x)
    return round_fp8(x, "e5m2" if grad else "e4m3")


class _Quant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, grad):
        ctx.name = name
        return _round(x, name, grad)

    @staticmethod
    def backward(ctx, g):
        return _Quant.apply(g, ctx.name, True), None, None


def q(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product, rounded to the active precision."""
    name = _PRECISION.get()
    if name == "f32" or x.device.type == "meta":
        return x
    return _Quant.apply(x, name, False)
