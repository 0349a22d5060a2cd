"""Carry JAX-trained weights into the port: flax variable trees -> state dicts.

The caller hands over the trees as nested dicts of numpy arrays (after
`jax.device_get`); nothing here imports JAX. Mappings:

- Dense kernel (in, out) -> weight (out, in); Conv kernel (kh, kw, I, O) ->
  (O, I, kh, kw), 3-D (kd, kh, kw, I, O) -> (O, I, kd, kh, kw). The
  generator's fc keeps its output order (fm_h, fm_w, C): the port reshapes it
  that way before going to NCHW. The discriminator's `fc` over [features ‖
  cond] keeps that input order too.
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  (eps 1e-5 in both frameworks).
- ConvLSTM: the fused i,f,g,o kernels as they are (`clstm/wx0`,
  `clstm/wx0_bias`, `clstm/cells/wh0`, ...). Attention: the scalar `gamma`.
- Embedding: as it is.
- flax OptimizedLSTMCell (`l{i}_fwd|l{i}_bwd/cell/{ii,if,ig,io}/kernel (in, H)`,
  `{hi,hf,hg,ho}/{kernel (H, H), bias}`) -> nn.LSTM's `weight_ih_l{i}[_reverse]`
  (transposes concatenated i, f, g, o), `weight_hh_l{i}[_reverse]` likewise,
  `bias_ih` = 0 and `bias_hh` = the h-biases.

- Discriminator (`MultiScaleDiscrim`): `discrim` or `discrim{i}` /
  `stem_conv1|stem_conv2|stem_skip`, `down{i}/conv1|conv2|conv_identity`,
  `attn/theta|phi|g|o` and `attn/gamma`, `fc_uncond`, `fc`, `cond_proj`.

Any key that is not mapped raises, except the decoder's `to_vocab`, which is on
neither the serving nor the training path.
"""

import re

import numpy as np
import torch

_GEN_PARAM = re.compile(
    r"^(?:(?:fc|clstm/wx0|clstm/cells/w[xh]\d+"
    r"|(?:base/)?up\d+/(?:bn1|bn2|conv1|conv2|conv_identity|attn/(?:theta|phi|g|o))"
    r"|render(?:_base|\d+)/(?:bn|conv))/(?:kernel|bias|scale)"
    r"|clstm/wx0_bias|(?:base/)?up\d+/attn/gamma)$")
_DISC_PARAM = re.compile(
    r"^discrim\d*/(?:(?:stem_conv1|stem_conv2|stem_skip|fc_uncond|fc|cond_proj"
    r"|down\d+/(?:conv1|conv2|conv_identity)|attn/(?:theta|phi|g|o))/(?:kernel|bias)"
    r"|attn/gamma)$")
_GEN_STAT = re.compile(r"^(?:(?:base/)?up\d+/bn[12]|render(?:_base|\d+)/bn)/(?:mean|var)$")
_ENC_CELL = re.compile(r"^encoder/l(\d+)_(fwd|bwd)/cell/([ih])([ifgo])/(kernel|bias)$")
_ENC_SKIP = re.compile(r"^encoder/to_vocab/(?:kernel|bias)$")
_GATES = "ifgo"


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v, dtype=np.float32)


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _kernel(a):
    if a.ndim == 5:       # (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
        return a.transpose(4, 3, 0, 1, 2)
    if a.ndim == 4:       # (kh, kw, I, O) -> (O, I, kh, kw)
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:       # (in, out) -> (out, in)
        return a.T
    raise ValueError(f"kernel of rank {a.ndim}")


def _params(params, pattern, what) -> dict:
    sd = {}
    for path, a in _flatten(params):
        if not pattern.match(path):
            raise KeyError(f"unmapped {what} param {path}")
        *mods, leaf = path.split("/")
        if leaf == "kernel":
            leaf, a = "weight", _kernel(a)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = _tensor(a)
    return sd


def jax_to_torch_generator(params, batch_stats=None) -> dict:
    """Generator `params` and `batch_stats` trees -> MultiScaleGen state dict."""
    sd = _params(params, _GEN_PARAM, "generator")
    for path, a in _flatten(batch_stats or {}):
        if not _GEN_STAT.match(path):
            raise KeyError(f"unmapped generator batch stat {path}")
        *mods, leaf = path.split("/")
        module = ".".join(mods)
        sd[f"{module}.running_{leaf}"] = _tensor(a)
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def jax_to_torch_discriminator(params) -> dict:
    """MultiScaleDiscrim `params` tree -> the port's MultiScaleDiscrim state dict."""
    return _params(params, _DISC_PARAM, "discriminator")


def jax_to_torch_encoder(params) -> dict:
    """Seq2Seq `params` tree -> the port's Seq2Seq state dict (encoder only)."""
    sd = {}
    cells = {}   # (layer, suffix) -> {"ii": kernel, "hi": (kernel, bias), ...}
    for path, a in _flatten(params):
        if path == "encoder/embed/embedding":
            sd["encoder.embed.weight"] = _tensor(a)
            continue
        if _ENC_SKIP.match(path):
            continue
        m = _ENC_CELL.match(path)
        if m is None:
            raise KeyError(f"unmapped encoder param {path}")
        layer, direction, src, gate, leaf = m.groups()
        if src == "i" and leaf == "bias":
            raise KeyError(f"unexpected input-kernel bias {path}")
        key = (int(layer), "" if direction == "fwd" else "_reverse")
        cells.setdefault(key, {})[f"{src}{gate}/{leaf}"] = a
    for (layer, suffix), c in sorted(cells.items()):
        try:
            w_ih = np.concatenate([c[f"i{g}/kernel"].T for g in _GATES])
            w_hh = np.concatenate([c[f"h{g}/kernel"].T for g in _GATES])
            b_hh = np.concatenate([c[f"h{g}/bias"] for g in _GATES])
        except KeyError as e:
            raise KeyError(f"encoder layer {layer}{suffix} lacks {e}") from None
        name = f"l{layer}{suffix}"
        sd[f"encoder.lstm.weight_ih_{name}"] = _tensor(w_ih)
        sd[f"encoder.lstm.weight_hh_{name}"] = _tensor(w_hh)
        sd[f"encoder.lstm.bias_ih_{name}"] = torch.zeros(w_ih.shape[0])
        sd[f"encoder.lstm.bias_hh_{name}"] = _tensor(b_hh)
    return sd
