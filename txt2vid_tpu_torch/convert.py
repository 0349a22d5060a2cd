"""Carry weights and train states between the JAX package and the port:
flax variable trees <-> state dicts, and the whole GanTrainState tree <->
the port's modules and optimizers.

The caller hands over the trees as nested dicts of numpy arrays (after
`jax.device_get`, or as utils/checkpoint.py reads them); nothing here imports
JAX. The torch_to_jax_* functions are the inverses, with tensor leaves in the
JAX layout (transposed views). Mappings:

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
  `bias_ih` = 0 and `bias_hh` = the h-biases; the decoder's `to_vocab` Dense
  -> its Linear. Seq2Seq's `encoder` and, with separate_decoder, its
  `sep_decoder` map alike.

- Discriminator (`MultiScaleDiscrim`): `discrim` or `discrim{i}` /
  `stem_conv1|stem_conv2|stem_skip`, `down{i}/conv1|conv2|conv_identity`,
  `attn/theta|phi|g|o` and `attn/gamma`, `fc_uncond`, `fc`, `cond_proj`.
- flax ConvTranspose kernel (*k, I, O) -> flipped along its spatial axes and
  permuted to torch's (I, O, *k) (models/layers.py says why); the no_lstm
  generator's `frame_seed_gen/dc{i}` are such kernels.
- The TCWYT, TGAN and image-GAN modules (models/tcwyt.py, tgan.py, img.py)
  map by their own structure (`module_to_flax`, `flax_to_module`): each
  torch parameter's name is its flax path with dots, and its owner's type
  says how the leaf maps (Dense, Conv, ConvTranspose, BatchNorm as above;
  the LayerNorm's (H, W, C) scale and bias -> (C, H, W)).

Any key that is not mapped raises.

The train state (train_step.py:113-120, as flax serializes it): `step`,
`g_vars` {params, batch_stats}, `d_vars` {"0": {params[, batch_stats]}, ...},
`txt_vars` {params} or None, `m_vars` the sample mapping's {params,
batch_stats} or None, and each optimizer's optax.adam state
{"0": {count, mu, nu}, "1": {}} (ScaleByAdamState, EmptyState), with `mu` and
`nu` trees {"g": params} and {"d": {"0": params, ...}}. They map onto torch
Adam's `exp_avg` / `exp_avg_sq` with the parameters' transposes and `count`
onto `step`. Under --sgd the state is optax.sgd's {"0": {"trace"}, "1": {}}
(TraceState, EmptyState), the trace onto torch SGD's `momentum_buffer`.
Under end2end the trees are {"g", "txt"} and {"d", "txt"} ({"g"} alone with
end2end_d_only), "txt" the encoder's params tree. BatchNorm's
`num_batches_tracked` has no counterpart.
"""

import re

import numpy as np
import torch

from txt2vid_tpu_torch.utils.msgpack import as_float32

_GEN_PARAM = re.compile(
    r"^(?:(?:fc|clstm/wx0|clstm/cells/w[xh]\d+|frame_seed_gen/(?:dc|bn)\d+"
    r"|(?:base/)?up\d+/(?:bn1|bn2|conv1|conv2|conv_identity|attn/(?:theta|phi|g|o))"
    r"|render(?:_base|\d+)/(?:bn|conv))/(?:kernel|bias|scale)"
    r"|clstm/wx0_bias|(?:base/)?up\d+/attn/gamma)$")
_DISC_PARAM = re.compile(
    r"^discrim\d*/(?:(?:stem_conv1|stem_conv2|stem_skip|fc_uncond|fc|cond_proj"
    r"|down\d+/(?:conv1|conv2|conv_identity)|attn/(?:theta|phi|g|o))/(?:kernel|bias)"
    r"|attn/gamma)$")
_GEN_STAT = re.compile(r"^(?:(?:base/)?up\d+/bn[12]|render(?:_base|\d+)/bn"
                       r"|frame_seed_gen/bn\d+)/(?:mean|var)$")
# the generator's transposed-convolution kernels (no_lstm's seed generator)
_GEN_TRANSPOSED = re.compile(r"^frame_seed_gen/dc\d+/kernel$")
_ENC_CELL = re.compile(
    r"^(encoder|sep_decoder)/l(\d+)_(fwd|bwd)/cell/([ih])([ifgo])/(kernel|bias)$")
_ENC_OTHER = re.compile(r"^(encoder|sep_decoder)/(?:embed/embedding|to_vocab/(kernel|bias))$")
_TORCH_ENC = re.compile(
    r"^(encoder|sep_decoder)\.(?:embed\.weight|to_vocab\.(weight|bias)"
    r"|lstm\.(weight_ih|weight_hh|bias_hh|bias_ih)_l(\d+)(_reverse)?)$")
_GATES = "ifgo"


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, as_float32(v)


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


def _transposed_kernel(a):
    """flax ConvTranspose kernel (*k, I, O) -> torch's (I, O, *k), flipped
    along the spatial axes."""
    n = a.ndim - 2
    return np.flip(a, axis=tuple(range(n))).transpose(n, n + 1, *range(n))


def _inverse_transposed_kernel(t):
    n = t.dim() - 2
    return t.permute(*range(2, n + 2), 0, 1).flip(tuple(range(n)))


def _params(params, pattern, what, transposed=None) -> dict:
    sd = {}
    for path, a in _flatten(params):
        if not pattern.match(path):
            raise KeyError(f"unmapped {what} param {path}")
        *mods, leaf = path.split("/")
        if transposed is not None and transposed.match(path):
            leaf, a = "weight", _transposed_kernel(a)
        elif leaf == "kernel":
            leaf, a = "weight", _kernel(a)
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = _tensor(a)
    return sd


def jax_to_torch_generator(params, batch_stats=None) -> dict:
    """Generator `params` and `batch_stats` trees -> MultiScaleGen state dict."""
    sd = _params(params, _GEN_PARAM, "generator", _GEN_TRANSPOSED)
    for path, a in _flatten(batch_stats or {}):
        if not _GEN_STAT.match(path):
            raise KeyError(f"unmapped generator batch stat {path}")
        *mods, leaf = path.split("/")
        module = ".".join(mods)
        sd[f"{module}.running_{leaf}"] = _tensor(a)
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _nest(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dicts with keys sorted at every level, the
    order a tree has after any jax.tree_util map."""
    out = {}
    for path in sorted(flat):
        node = out
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = flat[path]
    return _sorted(out)


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _inverse_kernel(t):
    if t.dim() == 5:      # (O, I, kd, kh, kw) -> (kd, kh, kw, I, O)
        return t.permute(2, 3, 4, 1, 0)
    if t.dim() == 4:      # (O, I, kh, kw) -> (kh, kw, I, O)
        return t.permute(2, 3, 1, 0)
    if t.dim() == 2:
        return t.t()
    raise ValueError(f"kernel of rank {t.dim()}")


def _to_params(sd, what, transposed=None) -> dict:
    """Parameter state dict -> flax params tree: a weight of rank >= 2 is a
    kernel (a transposed convolution's where `transposed` matches its path),
    of rank 1 a BatchNorm scale."""
    flat = {}
    for name, t in sd.items():
        *mods, leaf = name.split(".")
        if leaf == "weight" and transposed is not None and transposed.match(
                "/".join(mods + ["kernel"])):
            leaf, t = "kernel", _inverse_transposed_kernel(t)
        elif leaf == "weight":
            leaf, t = ("kernel", _inverse_kernel(t)) if t.dim() >= 2 else ("scale", t)
        elif leaf not in ("bias", "gamma", "wx0_bias"):
            raise KeyError(f"unmapped {what} parameter {name}")
        flat["/".join(mods + [leaf])] = t.detach()
    return _nest(flat)


def torch_to_jax_generator(state_dict) -> tuple[dict, dict]:
    """MultiScaleGen state dict (or a dict of its parameters alone) ->
    (params, batch_stats) trees; the inverse of jax_to_torch_generator."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            stats["/".join(mods + [leaf[len("running_"):]])] = t.detach()
        elif leaf != "num_batches_tracked":
            params[name] = t
    return _to_params(params, "generator", _GEN_TRANSPOSED), _nest(stats)


def torch_to_jax_discriminator(state_dict) -> dict:
    """The port's MultiScaleDiscrim state dict -> its flax params tree."""
    return _to_params(state_dict, "discriminator")


def torch_to_jax_encoder(state_dict, decoder: bool = True) -> dict:
    """The port's Seq2Seq state dict -> the flax Seq2Seq params tree; with
    decoder=False the encoder's LSTM and embedding alone (no to_vocab, no
    sep_decoder), what serving reads. Each gate's h-bias is bias_ih + bias_hh
    (flax's input kernels have none)."""
    flat = {}
    for name, t in state_dict.items():
        m = _TORCH_ENC.match(name)
        if m is None:
            raise KeyError(f"unmapped encoder parameter {name}")
        mod, tv_leaf, kind, layer, rev = m.groups()
        if not decoder and (mod == "sep_decoder" or tv_leaf):
            continue
        t = t.detach()
        if tv_leaf == "weight":
            flat[f"{mod}/to_vocab/kernel"] = t.t()
            continue
        if tv_leaf == "bias":
            flat[f"{mod}/to_vocab/bias"] = t
            continue
        if kind is None:
            flat[f"{mod}/embed/embedding"] = t
            continue
        if kind == "bias_ih":
            continue
        cell = f"{mod}/l{layer}_{'bwd' if rev else 'fwd'}/cell"
        src = "i" if kind == "weight_ih" else "h"
        if kind == "bias_hh":
            t = t + state_dict[name.replace("bias_hh", "bias_ih")].detach()
        for gate, part in zip(_GATES, t.chunk(4, dim=0)):
            if kind == "bias_hh":
                flat[f"{cell}/h{gate}/bias"] = part
            else:
                flat[f"{cell}/{src}{gate}/kernel"] = part.t()
    return _nest(flat)


def jax_to_torch_discriminator(params) -> dict:
    """MultiScaleDiscrim `params` tree -> the port's MultiScaleDiscrim state dict."""
    return _params(params, _DISC_PARAM, "discriminator")


def jax_to_torch_encoder(params) -> dict:
    """Seq2Seq `params` tree -> the port's Seq2Seq state dict (the encoder,
    to_vocab where the tree has it, and sep_decoder)."""
    sd = {}
    cells = {}   # (module, layer, suffix) -> {"ii/kernel": ..., "hi/bias": ..., ...}
    for path, a in _flatten(params):
        m = _ENC_OTHER.match(path)
        if m is not None:
            mod, leaf = m.groups()
            if leaf is None:
                sd[f"{mod}.embed.weight"] = _tensor(a)
            elif leaf == "kernel":
                sd[f"{mod}.to_vocab.weight"] = _tensor(a.T)
            else:
                sd[f"{mod}.to_vocab.bias"] = _tensor(a)
            continue
        m = _ENC_CELL.match(path)
        if m is None:
            raise KeyError(f"unmapped encoder param {path}")
        mod, layer, direction, src, gate, leaf = m.groups()
        if src == "i" and leaf == "bias":
            raise KeyError(f"unexpected input-kernel bias {path}")
        key = (mod, int(layer), "" if direction == "fwd" else "_reverse")
        cells.setdefault(key, {})[f"{src}{gate}/{leaf}"] = a
    for (mod, layer, suffix), c in sorted(cells.items()):
        try:
            w_ih = np.concatenate([c[f"i{g}/kernel"].T for g in _GATES])
            w_hh = np.concatenate([c[f"h{g}/kernel"].T for g in _GATES])
            b_hh = np.concatenate([c[f"h{g}/bias"] for g in _GATES])
        except KeyError as e:
            raise KeyError(f"{mod} layer {layer}{suffix} lacks {e}") from None
        name = f"l{layer}{suffix}"
        sd[f"{mod}.lstm.weight_ih_{name}"] = _tensor(w_ih)
        sd[f"{mod}.lstm.weight_hh_{name}"] = _tensor(w_hh)
        sd[f"{mod}.lstm.bias_ih_{name}"] = torch.zeros(w_ih.shape[0])
        sd[f"{mod}.lstm.bias_hh_{name}"] = _tensor(b_hh)
    return sd


# ------------------------------------------ modules mapped by their structure

def _leaf_kinds(module) -> dict:
    """Parameter name -> how its leaf maps: "dense", "conv", "transposed",
    "scale" (BatchNorm), "ln" (LayerNormCHW's scale and bias) or "plain"."""
    from torch import nn
    kinds = {}
    for prefix, m in module.named_modules():
        for name, _ in m.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            kind = "plain"
            if type(m).__name__ == "LayerNormCHW":
                kind = "ln"
            elif name == "weight":
                if isinstance(m, nn.Linear):
                    kind = "dense"
                elif isinstance(m, nn.modules.conv._ConvTransposeNd):
                    kind = "transposed"
                elif isinstance(m, nn.modules.conv._ConvNd):
                    kind = "conv"
                elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                    kind = "scale"
            kinds[full] = kind
    return kinds


_TO_FLAX = {"dense": lambda t: t.t(), "conv": _inverse_kernel,
            "transposed": _inverse_transposed_kernel, "ln": lambda t: t.permute(1, 2, 0),
            "scale": lambda t: t, "plain": lambda t: t}
_FROM_FLAX = {"dense": lambda a: a.T, "conv": _kernel, "transposed": _transposed_kernel,
              "ln": lambda a: a.transpose(2, 0, 1), "scale": lambda a: a,
              "plain": lambda a: a}


def _flax_leaf(name, kind):
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if kind in ("dense", "conv", "transposed") else "scale"
    return "/".join(mods + [leaf])


def module_to_flax(module, tensors=None) -> tuple[dict, dict]:
    """A module's (params, batch_stats) trees in the JAX layout. `tensors`
    (parameter name -> tensor, e.g. Adam moments) replaces the parameters;
    batch_stats come from the BatchNorm running statistics ({} without)."""
    kinds = _leaf_kinds(module)
    if tensors is None:
        tensors = dict(module.named_parameters())
    if set(tensors) != set(kinds):
        raise KeyError(f"tensors {sorted(set(tensors) ^ set(kinds))} do not fit the module")
    params = {_flax_leaf(n, kinds[n]): _TO_FLAX[kinds[n]](t.detach())
              for n, t in tensors.items()}
    stats = {}
    for name, t in module.named_buffers():
        *mods, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            stats["/".join(mods + [leaf[len("running_"):]])] = t.detach()
    return _nest(params), _nest(stats)


def flax_to_module(module, params, batch_stats=None) -> dict:
    """`params` (and `batch_stats`) trees of the module's JAX counterpart ->
    its state dict (or, without batch_stats, its parameters by name, e.g.
    Adam moments). Every leaf must map to one of the module's tensors and
    every parameter must be given."""
    kinds = _leaf_kinds(module)
    by_path = {_flax_leaf(n, k): n for n, k in kinds.items()}
    sd = {}
    for path, a in _flatten(params):
        if path not in by_path:
            raise KeyError(f"unmapped {type(module).__name__} param {path}")
        name = by_path[path]
        sd[name] = _tensor(_FROM_FLAX[kinds[name]](a))
    if len(sd) != len(kinds):
        raise KeyError(f"{type(module).__name__} params lack "
                       f"{sorted(set(kinds) - set(sd))}")
    if batch_stats is not None:
        buffers = dict(module.named_buffers())
        for path, a in _flatten(batch_stats):
            *mods, leaf = path.split("/")
            name = ".".join(mods + [f"running_{leaf}"])
            if leaf not in ("mean", "var") or name not in buffers:
                raise KeyError(f"unmapped {type(module).__name__} batch stat {path}")
            sd[name] = _tensor(a)
        for name, t in buffers.items():
            if name.endswith("num_batches_tracked"):
                sd[name] = torch.zeros_like(t)
    return sd


def _is_multiscale_gen(module):
    return type(module).__name__ == "MultiScaleGen"


def vars_to_jax(module, tensors=None) -> tuple[dict, dict]:
    """(params, batch_stats) trees of any of the port's GAN modules (the
    TGANv2 ones through their path maps, the others by structure);
    `tensors` as in module_to_flax."""
    sd = dict(module.named_parameters()) if tensors is None else tensors
    if _is_multiscale_gen(module):
        if tensors is None:
            return torch_to_jax_generator(module.state_dict())
        return torch_to_jax_generator(sd)[0], {}
    if getattr(module, "is_multiscale", False):
        return torch_to_jax_discriminator(sd), {}
    return module_to_flax(module, tensors)


def vars_to_torch(module, params, batch_stats=None) -> dict:
    """The inverse of vars_to_jax: the module's state dict (or its parameters
    by name when batch_stats is None and the module has statistics)."""
    if _is_multiscale_gen(module):
        return jax_to_torch_generator(params, batch_stats)
    if getattr(module, "is_multiscale", False):
        return jax_to_torch_discriminator(params)
    return flax_to_module(module, params, batch_stats)


def module_vars(module) -> dict:
    """The module's flax variables {"batch_stats"?, "params"}, as flax's init
    makes them (batch_stats only where the module has BatchNorm)."""
    params, stats = vars_to_jax(module)
    return {"batch_stats": stats, "params": params} if stats else {"params": params}


def load_module_vars(module, variables) -> None:
    """Load flax variables {"params"[, "batch_stats"]} into the module."""
    dev = next(module.parameters()).device
    sd = vars_to_torch(module, variables["params"], variables.get("batch_stats"))
    module.load_state_dict({k: v.to(dev) for k, v in sd.items()})


# ------------------------------------------------------------- the train state

def _adam_moments(opt, named_params, key):
    """name -> the optimizer's `key` moment in its storage dtype (zeros before
    the first step, and for a parameter outside the optimizer) and the step
    count (0 before it)."""
    out, count = {}, 0
    for name, p in named_params:
        st = opt.state.get(p, {})
        out[name] = (st[key] if st.get(key) is not None
                     else torch.zeros_like(p, dtype=_storage_dtype(opt, p, key)))
        if "step" in st:
            count = int(st["step"])
    return out, count


def _adam_tree(opt, named_params, wrap):
    """optax's state of `opt`: adam's {"0": {count, mu, nu}, "1": {}}, or for
    torch's SGD optax.sgd's {"0": {"trace"}, "1": {}} (TraceState,
    EmptyState), the momentum buffer as the trace."""
    if isinstance(opt, torch.optim.SGD):
        return {"0": {"trace": wrap(_adam_moments(opt, named_params, "momentum_buffer")[0])},
                "1": {}}
    mu, count = _adam_moments(opt, named_params, "exp_avg")
    nu, _ = _adam_moments(opt, named_params, "exp_avg_sq")
    return {"0": {"count": np.array(count, np.int32), "mu": wrap(mu), "nu": wrap(nu)},
            "1": {}}


def _encoder_tree(enc):
    return {"params": torch_to_jax_encoder(enc.state_dict())}


def _end2end(step) -> tuple[bool, bool]:
    """Whether the encoder is in (the G optimizer, the D optimizer): end2end
    puts it in both, end2end_d_only in D's alone (train_step.py:266-271)."""
    if not step.txt_params:
        return False, False
    return bool(step.config.end2end_txt_in_g), True


def torch_state_to_jax(step) -> dict:
    """The GanTrainState tree of a port TrainStep (its gan's modules, the
    sample mapping's variables, both optimizers and its step counter), leaves
    as tensors in the JAX layout. Under end2end an optimizer's trees hold the
    encoder's moments as a "txt" subtree beside "g" or "d"."""
    gan = step.gan
    d_named = [list(d.named_parameters()) for d in gan.discrims]
    g_named = list(gan.gen.named_parameters())
    txt_g, txt_d = _end2end(step)
    # the encoder's whole state dict: bias_ih, outside the optimizers, has
    # zero moments, which torch_to_jax_encoder adds to bias_hh's
    txt_named = ([(f"txt.{n}", p) for n, p in
                  gan.cond_encoder.state_dict(keep_vars=True).items()]
                 if txt_d else [])

    def with_txt(tree, moments, on):
        if on:
            tree["txt"] = torch_to_jax_encoder({n[4:]: moments[n] for n, _ in txt_named})
        return tree

    def wrap_g(moments):
        return with_txt({"g": vars_to_jax(gan.gen, {n: moments[n] for n, _ in g_named})[0]},
                        moments, txt_g)

    def wrap_d(moments):
        return with_txt(
            {"d": {str(k): vars_to_jax(d, {n: moments[f"{k}.{n}"] for n, _ in named})[0]
                   for k, (d, named) in enumerate(zip(gan.discrims, d_named))}},
            moments, txt_d)

    d_flat = [(f"{k}.{n}", p) for k, named in enumerate(d_named) for n, p in named]
    mapping = gan.sample_mapping
    return {
        "step": np.array(step.step, np.int32),
        "g_vars": module_vars(gan.gen),
        "d_vars": {str(k): module_vars(d) for k, d in enumerate(gan.discrims)},
        "txt_vars": None if gan.cond_encoder is None else _encoder_tree(gan.cond_encoder),
        "m_vars": None if mapping is None else module_vars(mapping),
        "opt_g_state": _adam_tree(step.opt_g, g_named + (txt_named if txt_g else []),
                                  wrap_g),
        "opt_d_state": _adam_tree(step.opt_d, d_flat + txt_named, wrap_d),
    }


def _storage_dtype(opt, p, key):
    """The dtype the optimizer stores moment `key` of `p` in: the parameter's
    for torch's Adam and SGD, the storage dtype for ops.optim.AdamStorage (of
    the first group for a parameter outside the optimizer)."""
    storage = getattr(opt, "storage_dtype", None)
    if storage is None:
        return p.dtype
    group = next((g for g in opt.param_groups if any(q is p for q in g["params"])),
                 opt.param_groups[0])
    return storage(group, p, key)


def _load_adam(opt, named_params, tree, unwrap):
    """Set each parameter's optimizer state from an optax state tree: adam's
    moments, each rounded to the dtype the optimizer stores it in, or for
    torch's SGD sgd's trace as the momentum buffer."""
    if isinstance(opt, torch.optim.SGD):
        trace = unwrap(tree["0"]["trace"])
        for name, p in named_params:
            opt.state[p] = {"momentum_buffer": trace[name].to(p.device, p.dtype).contiguous()}
        return
    adam = tree["0"]
    count = int(np.asarray(adam["count"]))
    mu, nu = unwrap(adam["mu"]), unwrap(adam["nu"])
    for name, p in named_params:
        if count == 0:
            opt.state.pop(p, None)
            continue
        opt.state[p] = {"step": torch.tensor(float(count)), **{
            key: moments[name].to(p.device, _storage_dtype(opt, p, key)).contiguous()
            for key, moments in (("exp_avg", mu), ("exp_avg_sq", nu))}}


def load_encoder_vars(enc, txt_vars):
    """Caption-encoder variables {"params": ...} into the port's Seq2Seq. A
    tree without to_vocab (the JAX encoder's encode-only init) leaves the
    decoder's projection as it is; any other key missing or left over
    raises."""
    dev = enc.encoder.embed.weight.device
    missing, unexpected = enc.load_state_dict(
        {k: v.to(dev) for k, v in jax_to_torch_encoder(txt_vars["params"]).items()},
        strict=False)
    to_vocab = {k for k in enc.state_dict() if ".to_vocab." in k}
    if unexpected or (missing and set(missing) != to_vocab):
        raise KeyError(f"the encoder tree does not fit the model: missing {missing}, "
                       f"unexpected {unexpected}")


def jax_state_to_torch(tree, step) -> None:
    """Load a GanTrainState tree (numpy leaves) into a port TrainStep: its
    gan's modules, the sample mapping, both optimizers' Adam states and its
    step counter."""
    gan = step.gan
    load_module_vars(gan.gen, tree["g_vars"])
    if len(tree["d_vars"]) != len(gan.discrims):
        raise ValueError(f"the state has {len(tree['d_vars'])} discriminators, "
                         f"the model {len(gan.discrims)}")
    for k, d in enumerate(gan.discrims):
        load_module_vars(d, tree["d_vars"][str(k)])
    if (tree.get("m_vars") is None) != (gan.sample_mapping is None):
        raise ValueError("the state and the model disagree on a sample mapping (--M)")
    if gan.sample_mapping is not None:
        load_module_vars(gan.sample_mapping, tree["m_vars"])
    if gan.cond_encoder is not None and tree.get("txt_vars") is not None:
        with torch.no_grad():
            load_encoder_vars(gan.cond_encoder, tree["txt_vars"])
    txt_g, txt_d = _end2end(step)
    txt_named = ([(f"txt.{n}", p) for n, p in gan.cond_encoder.named_parameters()
                  if p.requires_grad] if txt_d else [])

    def with_txt(out, t, on):
        if on:
            out.update({f"txt.{n}": v for n, v in jax_to_torch_encoder(t["txt"]).items()})
        return out

    _load_adam(step.opt_g, list(gan.gen.named_parameters()) + (txt_named if txt_g else []),
               tree["opt_g_state"],
               lambda t: with_txt(_param_tensors(gan.gen, t["g"]), t, txt_g))

    def unwrap_d(t):
        out = {}
        for k, d in enumerate(gan.discrims):
            out.update({f"{k}.{n}": v for n, v in _param_tensors(d, t["d"][str(k)]).items()})
        return with_txt(out, t, txt_d)

    _load_adam(step.opt_d, [(f"{k}.{n}", p) for k, d in enumerate(gan.discrims)
                            for n, p in d.named_parameters()] + txt_named,
               tree["opt_d_state"], unwrap_d)
    step.step = int(np.asarray(tree["step"]))


def _param_tensors(module, params) -> dict:
    """A params-shaped tree (Adam moments) -> tensors by parameter name."""
    sd = vars_to_torch(module, params)
    return {n: sd[n] for n, _ in module.named_parameters()}


# ------------------------------------------------- the sentence-pretrain state

def txt_state_to_jax(model, opt) -> dict:
    """train/txt.py's checkpoint tree {"optim": optax.adam's state, "txt":
    {"params": ...}} of a port Seq2Seq and its Adam; leaves as tensors in the
    JAX layout. Parameters outside the optimizer (the LSTM's bias_ih, which
    flax has no counterpart of) have zero moments."""
    named = list(model.state_dict(keep_vars=True).items())
    return {"optim": _adam_tree(opt, named, torch_to_jax_encoder),
            "txt": {"params": torch_to_jax_encoder(model.state_dict())}}


def jax_txt_state_to_torch(tree, model, opt) -> None:
    """Load a train/txt.py checkpoint tree (numpy leaves) into a port Seq2Seq
    and the Adam over its trainable parameters."""
    load_encoder_vars(model, tree["txt"])
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    _load_adam(opt, named, tree["optim"], jax_to_torch_encoder)
