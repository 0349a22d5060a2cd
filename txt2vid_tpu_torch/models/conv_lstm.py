"""ConvLSTM temporal core (counterpart of txt2vid_tpu/models/conv_lstm.py), NCHW.

Same semantics as the JAX module: gates i/f/g/o from an input conv (with bias)
and a hidden conv (no bias); the input is fed at t=0 only and zeros afterwards,
so the layer-0 input conv runs once and later steps see only its bias
(`wx0_bias`); state starts at zero; the reference's all-zero peepholes are
omitted. The gate convs keep the fused 4C layout (i, f, g, o along the output
channels). On a 1x1 plane every non-centre tap of a 3x3 SAME conv sees only
padding, so the conv is a matmul with the centre tap. With `dtype` (bf16)
the gate convs cast their input and weights (the LSTM state is then bf16) and
the `wx0_bias` plane takes the input's dtype, as the JAX module does.
"""

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from txt2vid_tpu_torch.models.layers import Conv2d, promote
from txt2vid_tpu_torch.ops.initializers import fused_gate_xavier_


def _gate_conv(conv: Conv2d, x):
    if x.shape[-2:] == (1, 1):
        k = conv.kernel_size[0] // 2
        x, weight, bias = promote(conv.compute_dtype, x, conv.weight[:, :, k, k], conv.bias)
        return F.linear(x.flatten(1), weight, bias)[:, :, None, None]
    return conv(x)


class ConvLSTM(nn.Module):
    """x (B, C, h, w) -> (B, step, hidden_channels[-1], h, w): all `step` outputs."""

    def __init__(self, in_channels: int, hidden_channels: Sequence[int],
                 kernel_size: int = 3, step: int = 16, dtype=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"ConvLSTM takes an odd kernel_size, got {kernel_size}")
        self.hidden_channels = tuple(hidden_channels)
        self.step = step
        pad = kernel_size // 2
        hc0 = self.hidden_channels[0]
        self.wx0 = Conv2d(in_channels, 4 * hc0, kernel_size, padding=pad, bias=False,
                          compute_dtype=dtype)
        self.wx0_bias = nn.Parameter(torch.zeros(4 * hc0))
        cells = {}
        for li, hc in enumerate(self.hidden_channels):
            if li:
                cells[f"wx{li}"] = Conv2d(self.hidden_channels[li - 1], 4 * hc,
                                          kernel_size, padding=pad, compute_dtype=dtype)
            cells[f"wh{li}"] = Conv2d(hc, 4 * hc, kernel_size, padding=pad, bias=False,
                                      compute_dtype=dtype)
        self.cells = nn.ModuleDict(cells)

    def init_weights(self, generator):
        fused_gate_xavier_(self.wx0.weight, generator=generator)
        nn.init.zeros_(self.wx0_bias)
        for conv in self.cells.values():
            fused_gate_xavier_(conv.weight, generator=generator)
            if conv.bias is not None:
                nn.init.zeros_(conv.bias)

    def forward(self, x):
        b, _, h, w = x.shape
        bias = self.wx0_bias.to(x.dtype)[:, None, None]
        gx0 = _gate_conv(self.wx0, x) + bias
        bias_plane = bias.expand_as(gx0)
        state = [(x.new_zeros(b, hc, h, w), x.new_zeros(b, hc, h, w))
                 for hc in self.hidden_channels]
        outs = []
        for t in range(self.step):
            inp = None
            for li in range(len(self.hidden_channels)):
                hid, cell = state[li]
                if li == 0:
                    gates = gx0 if t == 0 else bias_plane
                else:
                    gates = _gate_conv(self.cells[f"wx{li}"], inp)
                gates = gates + _gate_conv(self.cells[f"wh{li}"], hid)
                i, f, g, o = gates.chunk(4, dim=1)
                cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
                hid = torch.sigmoid(o) * torch.tanh(cell)
                state[li] = (hid, cell)
                inp = hid
            outs.append(inp)
        return torch.stack(outs, dim=1)
