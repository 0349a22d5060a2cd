"""Plain float32 PyTorch copies of the models the benchmark's configurations
run: the TGANv2 multi-scale generator and discriminator (the conditional
variant: [z | cond] into the generator's fc, a non-local attention in the
second-to-last additional up block, per-scale conds into the discriminator's
head) and the Seq2Seq Bi-LSTM caption encoder, its LSTM written out as
matmuls over masked time steps.

Written from the layer equations, not from the program: nothing here
imports the program. Parameter and buffer names are the program's state-dict
names, so that one set of weights, made by the benchmark, loads into both.
Every product goes through `precision.q`, so the same code computes the
lower-precision control. Attention calls are logged to an active `AttnLog`
with their shapes, for the roofline's count of the least time.
"""

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import q

_ATTN_LOG = contextvars.ContextVar("portbench_attn_log", default=None)
_IN_GP = contextvars.ContextVar("portbench_in_gp", default=False)
_BN_MODE = contextvars.ContextVar("portbench_bn_mode", default=None)


class AttnLog(list):
    """(B, N, M, d, dv, with_grad) of every attention the kernels would run:
    those outside the gradient penalty, whose attention runs the plain path
    in the program."""

    @contextlib.contextmanager
    def active(self):
        token = _ATTN_LOG.set(self)
        try:
            yield self
        finally:
            _ATTN_LOG.reset(token)


@contextlib.contextmanager
def in_gradient_penalty():
    token = _IN_GP.set(True)
    try:
        yield
    finally:
        _IN_GP.reset(token)


@contextlib.contextmanager
def calibrating_batch_norm():
    """BatchNorm normalises with the batch's statistics and stores them as its
    running statistics (to give random weights statistics that fit them)."""
    token = _BN_MODE.set("calibrate")
    try:
        yield
    finally:
        _BN_MODE.reset(token)


class _Leaves(nn.Module):
    """A module whose parameters and buffers carry an init kind:
    ("normal", std) or ("const", value)."""

    def leaf(self, name, shape, kind, buffer=False):
        t = torch.zeros(shape)
        if buffer:
            self.register_buffer(name, t)
        else:
            setattr(self, name, nn.Parameter(t))
        self.__dict__.setdefault("_kinds", {})[name] = kind


def xavier(shape):
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return ("normal", math.sqrt(2.0 / (fan_in + fan_out)))


def init_kinds(module: nn.Module) -> dict:
    """name -> init kind of every parameter and buffer of `module`."""
    kinds = {}
    for prefix, m in module.named_modules():
        for name, kind in m.__dict__.get("_kinds", {}).items():
            kinds[f"{prefix}.{name}" if prefix else name] = kind
    return kinds


class Conv(_Leaves):
    def __init__(self, cin, cout, k, nd, bias=True):
        super().__init__()
        shape = (cout, cin) + (k,) * nd
        self.nd, self.pad = nd, k // 2
        self.leaf("weight", shape, xavier(shape))
        self.has_bias = bias
        if bias:
            self.leaf("bias", (cout,), ("const", 0.0))

    def forward(self, x):
        conv = F.conv2d if self.nd == 2 else F.conv3d
        return conv(q(x), q(self.weight), self.bias if self.has_bias else None,
                    padding=self.pad)


class Linear(_Leaves):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.leaf("weight", (cout, cin), xavier((cout, cin)))
        self.has_bias = bias
        if bias:
            self.leaf("bias", (cout,), ("const", 0.0))

    def forward(self, x):
        return F.linear(q(x), q(self.weight), self.bias if self.has_bias else None)


class BatchNorm(_Leaves):
    """flax-style BatchNorm over channel axis 1: training normalises with the
    batch mean and biased variance, eval with the running statistics."""

    def __init__(self, ch, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.leaf("weight", (ch,), ("const", 1.0))
        self.leaf("bias", (ch,), ("const", 0.0))
        self.leaf("running_mean", (ch,), ("const", 0.0), buffer=True)
        self.leaf("running_var", (ch,), ("const", 1.0), buffer=True)

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training or _BN_MODE.get() == "calibrate":
            dims = (0, *range(2, x.dim()))
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            if _BN_MODE.get() == "calibrate":
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
        else:
            mean, var = self.running_mean, self.running_var
        x = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        return x * self.weight.reshape(shape) + self.bias.reshape(shape)


def attention(theta, phi, g):
    """softmax(theta phi^T) g over (B, N, d), (B, M, d), (B, M, dv); no scale."""
    log = _ATTN_LOG.get()
    if log is not None and not _IN_GP.get():
        b, n, d = theta.shape
        log.append((b, n, phi.shape[1], d, g.shape[2],
                    torch.is_grad_enabled() and theta.requires_grad))
    beta = torch.softmax(torch.einsum("bnd,bmd->bnm", q(theta), q(phi)), dim=-1)
    return torch.einsum("bnm,bmv->bnv", q(beta), q(g))


def tokens(x):
    """(B, C, *spatial) -> (B, prod(spatial), C), spatial axes in order."""
    return x.flatten(2).transpose(1, 2)


class NonLocal(_Leaves):
    """theta/phi C/8, g C/2, 2x2 spatial max pool on phi and g, output 1x1
    conv, residual weighted by gamma; 2-D (B, C, H, W) or 3-D (B, C, T, H, W)."""

    def __init__(self, ch, nd):
        super().__init__()
        self.nd = nd
        self.theta = Conv(ch, ch // 8, 1, nd, bias=False)
        self.phi = Conv(ch, ch // 8, 1, nd, bias=False)
        self.g = Conv(ch, ch // 2, 1, nd, bias=False)
        self.o = Conv(ch // 2, ch, 1, nd, bias=False)
        self.leaf("gamma", (), ("const", 0.5))

    def _pool(self, x):
        *lead, h, w = x.shape
        return x.reshape(*lead, h // 2, 2, w // 2, 2).amax(dim=(-3, -1))

    def forward(self, x):
        o = attention(tokens(self.theta(x)), tokens(self._pool(self.phi(x))),
                      tokens(self._pool(self.g(x))))
        o = o.transpose(1, 2).reshape(x.shape[0], -1, *x.shape[2:])
        return self.gamma * self.o(o) + x


def upsample(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class UpBlock(nn.Module):
    def __init__(self, cin, cout, with_non_local=False):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, cout, 3, 2)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout, 3, 2)
        self.conv_identity = Conv(cin, cout, 1, 2) if cin != cout else None
        self.attn = NonLocal(cout, 2) if with_non_local else None

    def forward(self, x):
        h = self.conv1(upsample(torch.relu(self.bn1(x))))
        h = self.conv2(torch.relu(self.bn2(h)))
        idn = upsample(x)
        if self.conv_identity is not None:
            idn = self.conv_identity(idn)
        h = idn + h
        return self.attn(h) if self.attn is not None else h


class BaseFrameGen(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.up0 = UpBlock(cin, 512)
        self.up1 = UpBlock(512, 256)
        self.up2 = UpBlock(256, 128)

    def forward(self, x):
        return self.up2(self.up1(self.up0(x)))


class RenderBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.bn = BatchNorm(cin)
        self.conv = Conv(cin, cout, 3, 2)

    def forward(self, x):
        return torch.tanh(self.conv(torch.relu(self.bn(x))))


class ConvLSTM(_Leaves):
    """One ConvLSTM layer unrolled `steps` times; the input is fed at t = 0
    only. Gates (i, f, g, o) along the output channels."""

    def __init__(self, ch, steps):
        super().__init__()
        self.steps = steps
        self.wx0 = Conv(ch, 4 * ch, 3, 2, bias=False)
        self.leaf("wx0_bias", (4 * ch,), ("const", 0.0))
        self.cells = nn.ModuleDict({"wh0": Conv(ch, 4 * ch, 3, 2, bias=False)})
        # the program inits the gate kernels per gate: fan_out is ch
        for conv in (self.wx0, self.cells["wh0"]):
            shape = conv.weight.shape
            conv._kinds["weight"] = xavier((shape[0] // 4,) + tuple(shape[1:]))

    def forward(self, x):
        bias = self.wx0_bias[:, None, None]
        gx0 = self.wx0(x) + bias
        hid = cell = torch.zeros_like(x)
        outs = []
        for t in range(self.steps):
            gates = (gx0 if t == 0 else bias) + self.cells["wh0"](hid)
            i, f, g, o = gates.chunk(4, dim=1)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            hid = torch.sigmoid(o) * torch.tanh(cell)
            outs.append(hid)
        return torch.stack(outs, dim=1)


class Generator(nn.Module):
    """z (B, latent) and cond (B, cond_dim) -> rendered scales (B, T, H, W, C).
    In training a subsample (every other item, frames from the phase) runs
    before every block after the base and every scale is rendered; at eval
    only the last."""

    def __init__(self, latent_size=256, cond_dim=256, width=64, num_channels=3,
                 additional_blocks=(64, 32, 32), fm_channels=1024, num_frames=16,
                 fm_stride=64, remat=False):
        super().__init__()
        self.latent_size, self.num_frames, self.fm_channels = latent_size, num_frames, fm_channels
        self.fm = max(1, width // fm_stride)
        self.remat = remat
        self.num_blocks = 1 + len(additional_blocks)
        self.fc = Linear(latent_size + cond_dim, self.fm * self.fm * fm_channels)
        self.clstm = ConvLSTM(fm_channels, num_frames)
        self.base = BaseFrameGen(fm_channels)
        self.render_base = RenderBlock(128, num_channels)
        prev = 128
        for i, ch in enumerate(additional_blocks):
            self.add_module(f"up{i}", UpBlock(prev, ch, i == len(additional_blocks) - 2))
            self.add_module(f"render{i}", RenderBlock(ch, num_channels))
            prev = ch

    def forward(self, z, cond, phases=None):
        train = self.training
        b = z.shape[0]
        x = self.fc(torch.cat([z, cond], dim=1))
        x = x.reshape(b, self.fm, self.fm, self.fm_channels).permute(0, 3, 1, 2)
        x = self.clstm(x)
        x = x.reshape((-1,) + x.shape[2:])
        frames = self.num_frames
        blocks = [self.base] + [getattr(self, f"up{i}") for i in range(self.num_blocks - 1)]
        renders = [self.render_base] + [getattr(self, f"render{i}")
                                        for i in range(self.num_blocks - 1)]
        out = []
        for i, (block, render) in enumerate(zip(blocks, renders)):
            if i and train:
                v = x.reshape((-1, frames) + x.shape[1:])[0::2, phases[i - 1]::2]
                frames //= 2
                x = v.reshape((-1,) + v.shape[2:])
            use_ckpt = self.remat and torch.is_grad_enabled() and x.device.type != "meta"
            x = checkpoint(block, x, use_reentrant=False) if use_ckpt else block(x)
            if train or i == len(blocks) - 1:
                r = render(x).permute(0, 2, 3, 1)
                out.append(r.reshape((-1, frames) + r.shape[1:]))
        return out


def avg_pool(x, kernel, stride, pad=(0, 0, 0)):
    return F.avg_pool3d(x, kernel, stride=stride, padding=pad, count_include_pad=True)


def shape_aware_pool(x):
    kernel = [1 if s == 1 else 2 for s in x.shape[2:]]
    if kernel == [1, 1, 1]:
        return x
    pad = [1 if s > 1 and s % 2 else 0 for s in x.shape[2:]]
    return avg_pool(x, kernel, kernel, pad)


class DownBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cin, 3, 3)
        self.conv2 = Conv(cin, cout, 3, 3)
        self.conv_identity = Conv(cin, cout, 1, 3)

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return shape_aware_pool(self.conv_identity(x)) + shape_aware_pool(h)


class Resnet3D(_Leaves):
    def __init__(self, num_channels, cond_dim, num_down_blocks, cond_head):
        super().__init__()
        self.cond_head, self.num_down_blocks = cond_head, num_down_blocks
        self.stem_conv1 = Conv(num_channels, 64, 3, 3)
        self.stem_conv2 = Conv(64, 64, 3, 3)
        self.stem_skip = Conv(num_channels, 64, 1, 3)
        ch, out = 64, 128
        for i in range(num_down_blocks):
            self.add_module(f"down{i}", DownBlock(ch, out))
            ch, out = out, out * 2
        self.attn = NonLocal(128, 3)
        self.fc_uncond = Linear(ch, 1)
        if cond_head == "proj":
            self.cond_proj = Linear(cond_dim, ch, bias=False)
            self.fc = Linear(ch, 1)
        else:
            self.fc = Linear(ch + cond_dim, 1)

    def features(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        h = self.stem_conv2(torch.relu(self.stem_conv1(x)))
        h = self.stem_skip(avg_pool(x, (1, 2, 2), (2, 2, 2))) + avg_pool(h, (1, 2, 2), (2, 2, 2))
        for i in range(self.num_down_blocks):
            h = getattr(self, f"down{i}")(h)
            if i == 0:
                h = self.attn(h)
        return h.sum(dim=(2, 3, 4))

    def head(self, feats, cond):
        if self.cond_head == "proj":
            return self.fc(feats) + (self.cond_proj(cond) * feats).sum(1, keepdim=True)
        return self.fc(torch.cat([feats, cond], dim=1))

    def forward(self, x, cond, feats=None):
        uncond = None
        if feats is None:
            feats = self.features(x)
            uncond = self.fc_uncond(feats)
        return uncond, self.head(feats, cond), feats


class Discriminator(nn.Module):
    """One Resnet3D shared by every scale (the program's single_discrim)."""

    def __init__(self, num_channels=3, cond_dim=256, discrim_down_blocks=(4, 4, 4, 4),
                 cond_head="concat"):
        super().__init__()
        self.discrim = Resnet3D(num_channels, cond_dim, discrim_down_blocks[-1], cond_head)

    def forward(self, xs, conds, feats=None):
        return [self.discrim(x, c, None if feats is None else f)
                for x, c, f in zip(xs, conds, feats or [None] * len(xs))]


class Encoder(nn.Module):
    """Seq2Seq's encoder: embedding, `num_layers` bidirectional LSTM layers of
    hidden_size / 2 per direction (gates i, f, g, o), and the sentence vector
    [last layer's forward final hidden | backward final hidden]. Padding is
    masked: a direction's state does not move on padded positions."""

    def __init__(self, vocab_size, embed_size=256, hidden_size=256, num_layers=4):
        super().__init__()
        self.num_layers, self.per_dir = num_layers, hidden_size // 2
        enc = nn.Module()
        enc.embed = _Leaves()
        enc.embed.leaf("weight", (vocab_size, embed_size), ("normal", 1.0))
        lstm = _Leaves()
        h = self.per_dir
        for k in range(num_layers):
            cin = embed_size if k == 0 else hidden_size
            for sfx in ("", "_reverse"):
                std = 1.0 / math.sqrt(h)
                lstm.leaf(f"weight_ih_l{k}{sfx}", (4 * h, cin), ("normal", std))
                lstm.leaf(f"weight_hh_l{k}{sfx}", (4 * h, h), ("normal", std))
                lstm.leaf(f"bias_ih_l{k}{sfx}", (4 * h,), ("const", 0.0))
                lstm.leaf(f"bias_hh_l{k}{sfx}", (4 * h,), ("const", 0.0))
        enc.lstm = lstm
        enc.to_vocab = Linear(hidden_size, vocab_size)
        self.encoder = enc

    def _direction(self, x, mask, k, sfx, reverse):
        lstm = self.encoder.lstm
        w_hh, b_hh = getattr(lstm, f"weight_hh_l{k}{sfx}"), getattr(lstm, f"bias_hh_l{k}{sfx}")
        gx = F.linear(q(x), q(getattr(lstm, f"weight_ih_l{k}{sfx}")),
                      getattr(lstm, f"bias_ih_l{k}{sfx}"))
        b, length, _ = x.shape
        hid = cell = x.new_zeros(b, self.per_dir)
        outs = [None] * length
        for t in (range(length - 1, -1, -1) if reverse else range(length)):
            gates = gx[:, t] + F.linear(q(hid), q(w_hh), b_hh)
            i, f, g, o = gates.chunk(4, dim=1)
            c_new = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[:, t, None]
            hid = m * h_new + (1 - m) * hid
            cell = m * c_new + (1 - m) * cell
            outs[t] = m * h_new
        return torch.stack(outs, dim=1), hid

    def forward(self, tokens_, lengths):
        """tokens (B, L) int64, lengths (B,) -> (B, hidden_size)."""
        x = self.encoder.embed.weight[tokens_]
        length = tokens_.shape[1]
        mask = (torch.arange(length, device=x.device)[None, :]
                < lengths.to(x.device)[:, None]).to(x.dtype)
        for k in range(self.num_layers):
            fwd, h_f = self._direction(x, mask, k, "", False)
            bwd, h_b = self._direction(x, mask, k, "_reverse", True)
            x = torch.cat([fwd, bwd], dim=-1)
        return torch.cat([h_f, h_b], dim=-1)
