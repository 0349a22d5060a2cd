"""Import checkpoints of the original PyTorch code (counterpart of
txt2vid_tpu/compat/torch_import.py).

The original trainer torch.saves a flat dict
``{optG, optD, gen, cond, sample_mapping?, <discrim-name>...}`` where every model
entry is a torch ``state_dict`` (its gan/trainer.py:269-279, cond_gan.py:186-196;
the discriminators are named ``discrim-%d`` by default, cond_gan.py:13-14). The
converters below, numpy key and layout transforms and the port's own copy of
the JAX package's, turn those state_dicts into flax variable trees of the
matching modules; `main` assembles a GanTrainState checkpoint (the JAX
package's format, utils/checkpoint.py) that the port's --weights/--resume,
sample, serve --weights and the eval CLIs read, and the JAX package too.

Layout rules (torch -> flax, channel-last):
  Conv{2,3}d weight (O, I, *k)    -> kernel (*k, I, O)
  Linear weight (O, I)            -> kernel (I, O)
  BatchNorm weight/bias           -> params scale/bias; running stats -> batch_stats
  LSTM weight_ih_l{k}[_reverse]   -> per-direction flax LSTMCell gate slices (i,f,g,o)
  ConvLSTM 8 per-gate convs       -> fused 4C input/hidden convs (conv_lstm.py)
  fc latent plane                 -> dense OUTPUT rows permuted (C,h,w)-major ->
                                     (h,w,C)-major (identity at the 1x1 plane of
                                     64px configs)
  nn.DataParallel's `module.`     -> dropped (strip_data_parallel)

Optimizer state is NOT imported: torch Adam moments are keyed to the original
parameter layout and do not transfer; the checkpoint carries fresh (zero) Adam
moments and step 0, so training resumes with optimizer warmup.

CLI (on the GPU unless --device says otherwise):
    python -m txt2vid_tpu_torch.compat.torch_import \\
        --ckpt ref_out/iter_10000_lossG_0.69_lossD_0.69 \\
        --G txt2vid_tpu.models.tganv2_cond.MultiScaleGen \\
        --D txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim \\
        --vocab vocab.pickle --frame_sizes 8 16 32 64 --out imported_ckpt
"""

from __future__ import annotations

import numpy as np


def _np(t):
    return np.asarray(t, dtype=np.float32)


class MissingKey(KeyError):
    pass


def _get(sd, key):
    if key not in sd:
        raise MissingKey(
            f"reference state_dict is missing '{key}' — wrong family/config for "
            f"this converter? (have e.g. {sorted(sd)[:6]}...)")
    return _np(sd[key])


def strip_data_parallel(sd):
    """Drop the '.module' path segments nn.DataParallel wrapping inserts
    (reference tganv2_cond/discrim.py:15,23)."""
    return {k.replace(".module.", ".").removeprefix("module."): v
            for k, v in sd.items()}


def _sub(sd, prefix):
    """The sub-dict under `prefix.` with the prefix stripped."""
    pl = len(prefix) + 1
    return {k[pl:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


# --- generic layer converters (state_dict level) ---------------------------------

def sd_conv(sd, p):
    """torch Conv{1,2,3}d at `p` -> flax nn.Conv params."""
    w = _get(sd, f"{p}.weight")
    out = {"kernel": np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def sd_dense(sd, p):
    out = {"kernel": _get(sd, f"{p}.weight").T}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def sd_convT(sd, p):
    """torch ConvTranspose{1,2,3}d at `p` -> flax nn.ConvTranspose params:
    weight (I, O, *k) -> spatially flipped kernel (*k, I, O)."""
    w = _get(sd, f"{p}.weight")
    w = np.flip(w, axis=tuple(range(2, w.ndim)))
    out = {"kernel": np.ascontiguousarray(
        np.transpose(w, tuple(range(2, w.ndim)) + (0, 1)))}
    if f"{p}.bias" in sd:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def sd_bn(sd, p):
    """torch BatchNorm at `p` -> (params, batch_stats)."""
    return ({"scale": _get(sd, f"{p}.weight"), "bias": _get(sd, f"{p}.bias")},
            {"mean": _get(sd, f"{p}.running_mean"),
             "var": _get(sd, f"{p}.running_var")})


def sd_attn(sd, p):
    """Attention / Attention3d (reference layers.py:10-68): theta/phi/g/o no-bias
    convs + scalar gamma."""
    return {"theta": sd_conv(sd, f"{p}.theta"), "phi": sd_conv(sd, f"{p}.phi"),
            "g": sd_conv(sd, f"{p}.g"), "o": sd_conv(sd, f"{p}.o"),
            "gamma": _get(sd, f"{p}.gamma")}


def sd_upblock(sd, p):
    """UpBlock (reference layers.py:152-195): main.inner_module Sequential indices
    0=BN 3=conv3x3 4=BN 6=conv3x3; identity 1x1 conv at main.identity_map.1 on
    channel change; optional trailing attn."""
    bn1_p, bn1_s = sd_bn(sd, f"{p}.main.inner_module.0")
    bn2_p, bn2_s = sd_bn(sd, f"{p}.main.inner_module.4")
    params = {"bn1": bn1_p, "conv1": sd_conv(sd, f"{p}.main.inner_module.3"),
              "bn2": bn2_p, "conv2": sd_conv(sd, f"{p}.main.inner_module.6")}
    stats = {"bn1": bn1_s, "bn2": bn2_s}
    if f"{p}.main.identity_map.1.weight" in sd:
        params["conv_identity"] = sd_conv(sd, f"{p}.main.identity_map.1")
    if f"{p}.attn.theta.weight" in sd:
        params["attn"] = sd_attn(sd, f"{p}.attn")
    return params, stats


def sd_downblock(sd, p):
    """DownBlock (reference layers.py:219-243): inner_module 1=conv 3=conv,
    identity_map.0 = 1x1 conv."""
    return {"conv1": sd_conv(sd, f"{p}.main.inner_module.1"),
            "conv2": sd_conv(sd, f"{p}.main.inner_module.3"),
            "conv_identity": sd_conv(sd, f"{p}.main.identity_map.0")}


def sd_render(sd, p):
    bn_p_, bn_s_ = sd_bn(sd, f"{p}.bn")
    return ({"bn": bn_p_, "conv": sd_conv(sd, f"{p}.conv")}, {"bn": bn_s_})


def sd_convlstm(sd, p):
    """ConvLSTM (reference conv_lstm.py): 8 per-gate convs per cell -> our fused
    4C input/hidden convs (gate order i, f, g=c, o; models/conv_lstm.py)."""
    num_layers = 0
    while f"{p}.cell{num_layers}.Wxi.weight" in sd:
        num_layers += 1
    if num_layers == 0:
        raise MissingKey(f"no ConvLSTM cells under '{p}.cell0'")
    params = {"cells": {}}
    for li in range(num_layers):
        c = f"{p}.cell{li}"
        wx = np.concatenate(
            [sd_conv(sd, f"{c}.Wx{g}")["kernel"] for g in "ifco"], axis=-1)
        bx = np.concatenate([_get(sd, f"{c}.Wx{g}.bias") for g in "ifco"])
        wh = np.concatenate(
            [sd_conv(sd, f"{c}.Wh{g}")["kernel"] for g in "ifco"], axis=-1)
        if li == 0:
            params["wx0"] = {"kernel": wx}
            params["wx0_bias"] = bx
        else:
            params["cells"][f"wx{li}"] = {"kernel": wx, "bias": bx}
        params["cells"][f"wh{li}"] = {"kernel": wh}
    return params


def sd_resnet3d(sd, p=""):
    """Resnet3D (reference resnet3d.py): stem residual block, DownBlocks with an
    optional Attention3d at down.1, sum-pool heads. No BN -> params only. The
    `down` ModuleList interleaves blocks and the attention, so flax down{i}
    indices skip it."""
    q = (p + ".") if p else ""
    params = {"stem_conv1": sd_conv(sd, f"{q}res_block.inner_module.0"),
              "stem_conv2": sd_conv(sd, f"{q}res_block.inner_module.2"),
              "stem_skip": sd_conv(sd, f"{q}res_block.identity_map.1"),
              "fc_uncond": sd_dense(sd, f"{q}fc_uncond")}
    di = mi = 0
    while True:
        if f"{q}down.{mi}.theta.weight" in sd:        # Attention3d entry
            params["attn"] = sd_attn(sd, f"{q}down.{mi}")
        elif f"{q}down.{mi}.main.inner_module.1.weight" in sd:
            params[f"down{di}"] = sd_downblock(sd, f"{q}down.{mi}")
            di += 1
        else:
            break
        mi += 1
    if di == 0:
        raise MissingKey(f"no DownBlocks under '{q}down'")
    if f"{q}fc.weight" in sd:
        # the reference's "concat" conditional head (resnet3d.py:33-35); a "proj"
        # head has no reference counterpart and cannot be imported
        params["fc"] = sd_dense(sd, f"{q}fc")
    return params


# --- model-level converters -------------------------------------------------------

def _fc_perm(fm_c, fm_h, fm_w):
    """Output-row permutation for the latent-plane fc: the reference views the dense
    output (C, h, w) c-major (tganv2/gen.py:68); ours reshapes (h, w, C). Identity
    at the 1x1 plane of 64px configs."""
    return np.arange(fm_c * fm_h * fm_w).reshape(fm_c, fm_h, fm_w) \
        .transpose(1, 2, 0).reshape(-1)


def multiscale_gen_vars(sd, fm_hw=None):
    """TGANv2 / TGANv2-cond MultiScaleGen state_dict -> flax variables
    {"params", "batch_stats"} of the (conditional) TGANv2 MultiScaleGen.

    `fm_hw`: (fm_h, fm_w) of the latent plane when it is larger than 1x1 and
    non-square; inferred as square otherwise.

    no_lstm checkpoints (FrameSeedGenerator temporal core, reference
    tganv2/gen.py:40-43) convert too: the seed stack's deconv/BN weights map
    leaf-for-leaf. Note the reference's forward reinterprets the seed output
    (B, fm_size, 16) with a raw `.view(B, 16, -1, h, w)` (gen.py:73-74) — a
    layout scramble that mixes the time axis into channels, so its "16 frame
    seeds" are not actually per-frame. Our no_lstm path implements the intended
    semantics (seed t is frame t), as the JAX package does: a checkpoint
    imports leaf for leaf, and its videos follow the corrected view."""
    sd = strip_data_parallel(sd)
    no_lstm = any(k.startswith("frame_seed_gen.") for k in sd)

    # latent-plane geometry from the weights themselves: fm_channels is the
    # ConvLSTM hidden width (or, for no_lstm, the BaseFrameGen pre-act BN width,
    # since the seed stack's fm_size folds the plane in); fm_h*fm_w = fc rows /
    # fm_channels
    if no_lstm:
        fm_c = _get(sd, "abstract_blocks.0.up0.main.inner_module.0.weight").shape[0]
    else:
        fm_c = _get(sd, "clstm.cell0.Wxi.weight").shape[0]
    fc_rows = _get(sd, "fc.weight").shape[0]
    plane = fc_rows // fm_c
    if fm_hw is not None:
        fm_h, fm_w = fm_hw
    else:
        fm_h = fm_w = int(round(plane ** 0.5))
    assert fm_h * fm_w == plane, \
        f"latent plane {plane} != {fm_h}x{fm_w}; pass fm_hw=(h, w)"

    stats = {}
    if no_lstm:
        # fc feeds the seed stack as a flat vector (no plane view before the 1D
        # deconvs), so fc rows keep the reference order; the (C, h, w)-major vs
        # (h, w, C)-minor plane split happens on the SEED output instead, so the
        # permutation lands on dc4's output rows (identity at the 1x1 plane of
        # 64px configs).
        params = {"fc": sd_dense(sd, "fc")}
        fs_p, fs_s = _fsgen_vars(sd, "frame_seed_gen")
        if fm_h * fm_w > 1:
            perm = _fc_perm(fm_c, fm_h, fm_w)
            fs_p["dc4"] = {"kernel": fs_p["dc4"]["kernel"][..., perm],
                           "bias": fs_p["dc4"]["bias"][perm]}
        params["frame_seed_gen"] = fs_p
        stats["frame_seed_gen"] = fs_s
    else:
        perm = _fc_perm(fm_c, fm_h, fm_w)
        fc = sd_dense(sd, "fc")
        params = {"fc": {"kernel": fc["kernel"][:, perm], "bias": fc["bias"][perm]},
                  "clstm": sd_convlstm(sd, "clstm")}

    # abstract_blocks.0 is BaseFrameGen (up0/up1/up2); the rest are UpBlocks
    params["base"], stats["base"] = {}, {}
    for i in range(3):
        bp, bs = sd_upblock(sd, f"abstract_blocks.0.up{i}")
        params["base"][f"up{i}"] = bp
        stats["base"][f"up{i}"] = bs
    n_additional = 0
    while f"abstract_blocks.{n_additional + 1}.main.inner_module.0.weight" in sd:
        bp, bs = sd_upblock(sd, f"abstract_blocks.{n_additional + 1}")
        params[f"up{n_additional}"] = bp
        stats[f"up{n_additional}"] = bs
        n_additional += 1

    names = ["render_base"] + [f"render{i}" for i in range(n_additional)]
    for i, name in enumerate(names):
        rp, rs = sd_render(sd, f"render_blocks.{i}")
        params[name] = rp
        stats[name] = rs
    return {"params": params, "batch_stats": stats}


def multiscale_discrim_vars(sd):
    """TGANv2 / TGANv2-cond MultiScaleDiscrim state_dict -> flax variables for
    the (conditional) TGANv2 MultiScaleDiscrim (cond_head="concat")."""
    sd = strip_data_parallel(sd)
    if any(k.startswith("single_discrim.") for k in sd):
        return {"params": {"discrim": sd_resnet3d(sd, "single_discrim")}}
    params, i = {}, 0
    while any(k.startswith(f"sub_discrims.{i}.") for k in sd):
        params[f"discrim{i}"] = sd_resnet3d(sd, f"sub_discrims.{i}")
        i += 1
    if i == 0:
        raise MissingKey("neither single_discrim nor sub_discrims.* present")
    return {"params": params}


def resnet3d_vars(sd):
    """Bare Resnet3D state_dict (e.g. a TGAN discriminator entry)."""
    return {"params": sd_resnet3d(strip_data_parallel(sd))}


def _lstm_layer(sd, p, layer, reverse):
    sfx = f"_l{layer}" + ("_reverse" if reverse else "")
    w_ih = _get(sd, f"{p}.weight_ih{sfx}")          # (4H, in), gates i,f,g,o
    w_hh = _get(sd, f"{p}.weight_hh{sfx}")
    b = _get(sd, f"{p}.bias_ih{sfx}") + _get(sd, f"{p}.bias_hh{sfx}")
    hdim = w_hh.shape[1]
    cell = {}
    for gi, g in enumerate("ifgo"):
        sl = slice(gi * hdim, (gi + 1) * hdim)
        cell[f"i{g}"] = {"kernel": w_ih[sl].T}
        cell[f"h{g}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
    return {"cell": cell}


def _recurrent_vars(sd, p, bi):
    out = {"embed": {"embedding": _get(sd, f"{p}.embed.weight")}}
    num_layers = 0
    while f"{p}.lstm.weight_ih_l{num_layers}" in sd:
        num_layers += 1
    if num_layers == 0:
        raise MissingKey(f"no LSTM layers under '{p}.lstm'")
    for i in range(num_layers):
        out[f"l{i}_fwd"] = _lstm_layer(sd, f"{p}.lstm", i, False)
        if bi:
            out[f"l{i}_bwd"] = _lstm_layer(sd, f"{p}.lstm", i, True)
    if f"{p}.to_vocab.weight" in sd:
        out["to_vocab"] = sd_dense(sd, f"{p}.to_vocab")
    return out


def seq2seq_vars(sd):
    """Reference Seq2Seq state_dict -> flax variables of models/txt.Seq2Seq.

    The reference registers the shared decoder twice ('encoder.*' and 'decoder.*'
    aliases of the same tensors, basic.py:10-16); a separate decoder is detected by
    a unidirectional 'decoder.lstm' (no _reverse weights)."""
    sd = strip_data_parallel(sd)
    params = {"encoder": _recurrent_vars(sd, "encoder", bi=True)}
    separate = (any(k.startswith("decoder.") for k in sd)
                and "decoder.lstm.weight_ih_l0_reverse" not in sd)
    if separate:
        params["sep_decoder"] = _recurrent_vars(sd, "decoder", bi=False)
    return {"params": params}


# --- TCWYT family (reference models/tcwyt/) ---------------------------------------

def tcwyt_gen_vars(sd):
    """TCWYT Gen (reference tcwyt/gen.py): input_map MLP+BN1d, then the seq
    Sequential of 5 ConvTranspose3d (+BN3d between) at indices 0,3,6,9,12."""
    sd = strip_data_parallel(sd)
    params = {"input_map": sd_dense(sd, "input_map.0")}
    stats = {}
    params["input_bn"], stats["input_bn"] = sd_bn(sd, "input_map.1")
    for di, si in enumerate((0, 3, 6, 9, 12)):
        params[f"dc{di}"] = sd_convT(sd, f"seq.{si}")
        if di < 4:
            params[f"bn{di}"], stats[f"bn{di}"] = sd_bn(sd, f"seq.{si + 1}")
    return {"params": params, "batch_stats": stats}


def tcwyt_video_discrim_vars(sd):
    """TCWYT VideoDiscrim (reference tcwyt/video_discrim.py): x_map conv pyramid
    (indices 0,2,3,5,6,8,9), optional cond_map MLP + pred Sequential (cond) or a
    single pred conv (uncond)."""
    sd = strip_data_parallel(sd)
    params = {"conv0": sd_conv(sd, "x_map.0"), "conv1": sd_conv(sd, "x_map.2"),
              "conv2": sd_conv(sd, "x_map.5"), "conv3": sd_conv(sd, "x_map.8")}
    stats = {}
    for i, si in zip((1, 2, 3), (3, 6, 9)):
        params[f"bn{i}"], stats[f"bn{i}"] = sd_bn(sd, f"x_map.{si}")
    if "cond_map.0.weight" in sd:
        params["cond_map"] = sd_dense(sd, "cond_map.0")
        params["cond_bn"], stats["cond_bn"] = sd_bn(sd, "cond_map.1")
        params["pred0"] = sd_conv(sd, "pred.0")
        params["pred_bn"], stats["pred_bn"] = sd_bn(sd, "pred.1")
        params["pred1"] = sd_conv(sd, "pred.3")
    else:
        params["pred"] = sd_conv(sd, "pred")
    return {"params": params, "batch_stats": stats}


def tcwyt_frame_map_vars(sd):
    """TCWYT FrameMap, the --M sample mapping (reference frame_discrim.py:4-37):
    per-frame conv pyramid at frame_map indices 0,3,6,9 with BNs between."""
    sd = strip_data_parallel(sd)
    params, stats = {}, {}
    for di, si in enumerate((0, 3, 6, 9)):
        params[f"conv{di}"] = sd_conv(sd, f"frame_map.{si}")
        if di < 3:
            params[f"bn{di}"], stats[f"bn{di}"] = sd_bn(sd, f"frame_map.{si + 1}")
    return {"params": params, "batch_stats": stats}


def _tcwyt_sent_head_vars(sd, map_attr):
    """Shared frame/motion discriminator head (reference frame_discrim.py:40-90,
    motion_discrim.py): per-frame 1x1 conv+BN map, tiled sent_map MLP, predictor."""
    sd = strip_data_parallel(sd)
    params = {"map": sd_conv(sd, f"{map_attr}.0"),
              "pred0": sd_conv(sd, "predictor.0"),
              "pred1": sd_conv(sd, "predictor.3"),
              "sent_map": sd_dense(sd, "sent_map.0")}
    stats = {}
    params["map_bn"], stats["map_bn"] = sd_bn(sd, f"{map_attr}.1")
    params["pred_bn"], stats["pred_bn"] = sd_bn(sd, "predictor.1")
    params["sent_bn"], stats["sent_bn"] = sd_bn(sd, "sent_map.1")
    return {"params": {"head": params}, "batch_stats": {"head": stats}}


def tcwyt_frame_discrim_vars(sd):
    return _tcwyt_sent_head_vars(sd, "frame_map")


def tcwyt_motion_discrim_vars(sd):
    return _tcwyt_sent_head_vars(sd, "motion_map")


# --- TGAN family (reference models/tgan/) ------------------------------------------

def _fsgen_vars(sd, p):
    """FrameSeedGenerator (reference tgan/temporal_gen.py): 1D deconv stack
    dc0..dc4 with BN1d between."""
    params, stats = {}, {}
    for i in range(5):
        params[f"dc{i}"] = sd_convT(sd, f"{p}.dc{i}")
        if i < 4:
            params[f"bn{i}"], stats[f"bn{i}"] = sd_bn(sd, f"{p}.bn{i}")
    return params, stats


def tgan_gen_vars(sd):
    """TGAN Gen (reference tgan/gen.py): _fsgen FrameSeedGenerator + _vgen
    VideoFrameGenerator. The l0s/l0f dense outputs are viewed (C, bw, bw) c-major
    by torch and (bw, bw, C) by ours — output rows permuted; bw inferred from the
    weights (rows / (conv_ch/2))."""
    sd = strip_data_parallel(sd)
    p_fs, s_fs = _fsgen_vars(sd, "_fsgen")

    conv_ch = _get(sd, "_vgen.dc1.weight").shape[0]       # ConvT (I, O, k, k)
    rows = _get(sd, "_vgen.l0s.weight").shape[0]
    bw = int(round((rows // (conv_ch // 2)) ** 0.5))
    assert bw * bw * (conv_ch // 2) == rows, \
        f"vgen l0s rows {rows} not (bw^2 * {conv_ch // 2})"
    perm = np.arange(rows).reshape(conv_ch // 2, bw, bw).transpose(1, 2, 0) \
        .reshape(-1)

    def dense_perm(p):
        d = sd_dense(sd, p)
        return {"kernel": d["kernel"][:, perm], "bias": d["bias"][perm]}

    def bn_perm(p):
        bp, bs = sd_bn(sd, p)
        return ({k: v[perm] for k, v in bp.items()},
                {k: v[perm] for k, v in bs.items()})

    p_vg = {"l0s": dense_perm("_vgen.l0s"), "l0f": dense_perm("_vgen.l0f")}
    s_vg = {}
    p_vg["bn0s"], s_vg["bn0s"] = bn_perm("_vgen.bn0s")
    p_vg["bn0f"], s_vg["bn0f"] = bn_perm("_vgen.bn0f")
    for i in range(1, 5):
        p_vg[f"dc{i}"] = sd_convT(sd, f"_vgen.dc{i}")
        p_vg[f"bn{i}"], s_vg[f"bn{i}"] = sd_bn(sd, f"_vgen.bn{i}")
    p_vg["dc5"] = sd_convT(sd, "_vgen.dc5")

    return {"params": {"fsgen": p_fs, "vgen": p_vg},
            "batch_stats": {"fsgen": s_fs, "vgen": s_vg}}


# --- image WGAN-GP pair (reference models/img/models.py) ---------------------------

def _img_ln_affine(sd, p):
    """torch LayerNorm([C, H, W]) affine -> ours (H, W, C)."""
    return {"scale": _get(sd, f"{p}.weight").transpose(1, 2, 0),
            "bias": _get(sd, f"{p}.bias").transpose(1, 2, 0)}


def img_gen_vars(sd):
    """img Gen (reference img/models.py:172-202): ln1 dense rows are (C, 4, 4)
    c-major in torch, (4, 4, C)-major in ours; dim inferred from rb1's shortcut."""
    sd = strip_data_parallel(sd)
    ch8 = _get(sd, "rb1.conv_shortcut.conv.conv.weight").shape[1]   # 8*dim in
    rows = _get(sd, "ln1.weight").shape[0]
    assert rows == ch8 * 16, f"img gen ln1 rows {rows} != 16*{ch8}"
    perm = np.arange(rows).reshape(ch8, 4, 4).transpose(1, 2, 0).reshape(-1)
    ln1 = sd_dense(sd, "ln1")
    params = {"ln1": {"kernel": ln1["kernel"][:, perm], "bias": ln1["bias"][perm]},
              "conv1": sd_conv(sd, "conv1.conv")}
    stats = {}
    params["bn"], stats["bn"] = sd_bn(sd, "bn")
    for i in range(1, 5):
        rb, rs = {}, {}
        rb["conv_shortcut"] = sd_conv(sd, f"rb{i}.conv_shortcut.conv.conv")
        rb["conv1"] = sd_conv(sd, f"rb{i}.conv_1.conv.conv")
        rb["conv2"] = sd_conv(sd, f"rb{i}.conv_2.conv")
        rb["bn1"], rs["bn1"] = sd_bn(sd, f"rb{i}.bn1")
        rb["bn2"], rs["bn2"] = sd_bn(sd, f"rb{i}.bn2")
        params[f"rb{i}"], stats[f"rb{i}"] = rb, rs
    return {"params": params, "batch_stats": stats}


def img_discrim_vars(sd):
    """img Discrim (reference img/models.py:143-170): final ln1 dense columns are
    (C, 4, 4) c-major; down-block norms are LayerNorms over (C, H, W)."""
    sd = strip_data_parallel(sd)
    ch8 = _get(sd, "rb4.conv_2.conv.conv.weight").shape[0]          # 8*dim out
    w = _get(sd, "ln1.weight")                                      # (1, 16*8d)
    perm = np.arange(w.shape[1]).reshape(ch8, 4, 4).transpose(1, 2, 0).reshape(-1)
    params = {"conv1": sd_conv(sd, "conv1.conv"),
              "ln1": {"kernel": w[:, perm].T, "bias": _get(sd, "ln1.bias")}}
    for i in range(1, 5):
        params[f"rb{i}"] = {
            "conv_shortcut": sd_conv(sd, f"rb{i}.conv_shortcut.conv.conv"),
            "conv1": sd_conv(sd, f"rb{i}.conv_1.conv"),
            "conv2": sd_conv(sd, f"rb{i}.conv_2.conv.conv"),
            "ln1": _img_ln_affine(sd, f"rb{i}.bn1"),
            "ln2": _img_ln_affine(sd, f"rb{i}.bn2")}
    return {"params": params}


# --- family dispatch ----------------------------------------------------------------

def converter_for(module):
    """The state_dict converter for a constructed port module, by its module's
    last name and its class (the tganv2_cond classes are partials of
    tganv2's, and dispatch as those)."""
    name = type(module).__name__
    pkg = type(module).__module__.rsplit(".", 1)[-1]
    table = {
        ("tganv2", "MultiScaleGen"): multiscale_gen_vars,
        ("tganv2", "MultiScaleDiscrim"): multiscale_discrim_vars,
        ("tcwyt", "Gen"): tcwyt_gen_vars,
        ("tcwyt", "VideoDiscrim"): tcwyt_video_discrim_vars,
        ("tcwyt", "FrameDiscrim"): tcwyt_frame_discrim_vars,
        ("tcwyt", "MotionDiscrim"): tcwyt_motion_discrim_vars,
        ("tcwyt", "FrameMap"): tcwyt_frame_map_vars,
        ("tgan", "Gen"): tgan_gen_vars,
        ("img", "Gen"): img_gen_vars,
        ("img", "Discrim"): img_discrim_vars,
        ("resnet3d", "Resnet3D"): resnet3d_vars,
    }
    try:
        return table[(pkg, name)]
    except KeyError:
        raise NotImplementedError(
            f"no reference-checkpoint converter for {pkg}.{name}") from None


# --- checkpoint assembly ----------------------------------------------------------

def load_reference_checkpoint(path) -> dict:
    """torch.load the original trainer's flat checkpoint dict, tensors -> numpy;
    the optimizer entries (optG, optD) are dropped, and a whole-module save
    (train/txt.py style) is read through its state_dict."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for name, entry in raw.items():
        if name in ("optG", "optD"):
            continue  # torch optimizer state does not transfer
        if hasattr(entry, "state_dict"):
            entry = entry.state_dict()
        out[name] = {k: v.detach().cpu().numpy() for k, v in entry.items()}
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _check(name, got, want_tree):
    """`got` (a converted tree) in the structure, order and dtypes of
    `want_tree` (the template's entry); a path missing or extra, or a shape
    that differs, raises ValueError naming the entry."""
    got_flat, want_flat = dict(_flat(got)), dict(_flat(want_tree))
    missing, extra = set(want_flat) - set(got_flat), set(got_flat) - set(want_flat)
    if missing or extra:
        raise ValueError(
            f"{name}: imported tree mismatches the target template "
            f"(family/config flags must match the reference run)\n"
            f"  missing from import: {sorted(missing)[:8]}\n"
            f"  unexpected in import: {sorted(extra)[:8]}")

    def leaf(path, tgt):
        src = got_flat[path]
        if np.shape(src) != tgt.shape:
            raise ValueError(f"{name}: shape {np.shape(src)} != target {tgt.shape} at {path}")
        return np.asarray(src, tgt.dtype)

    def build(tmpl, prefix=""):
        return {k: build(v, f"{prefix}/{k}" if prefix else k) if isinstance(v, dict)
                else leaf(f"{prefix}/{k}" if prefix else k, v) for k, v in tmpl.items()}

    return build(want_tree)


def main(args) -> str:
    """Write the imported checkpoint to args.out; returns its path. The
    template is the GanTrainState tree of a port TrainStep over the CondGan
    of --G/--D/--M/--sent with Adam at 1e-4 (convert.torch_state_to_jax):
    the converted variables replace its models', its moments stay zero and
    its step 0."""
    import torch

    from txt2vid_tpu_torch import resolve_device
    from txt2vid_tpu_torch.config import create_object
    from txt2vid_tpu_torch.convert import torch_state_to_jax
    from txt2vid_tpu_torch.data import load_pickle
    from txt2vid_tpu_torch.gan.cond_gan import CondGan
    from txt2vid_tpu_torch.gan.train_step import (TrainConfig, adam, build_train_step,
                                                  optimizer_params)
    from txt2vid_tpu_torch.utils import status
    from txt2vid_tpu_torch.utils.checkpoint import save_state, to_host

    device = resolve_device(args.device)
    sds = load_reference_checkpoint(args.ckpt)
    status(f"reference checkpoint entries: {sorted(sds)}")

    cond_dim = 0
    txt_encoder = None
    with torch.device(device):      # the modules' default init runs there
        if "cond" in sds:
            vocab_size = args.vocab_size or len(load_pickle(args.vocab))
            txt_encoder = create_object(args.sent, vocab_size=vocab_size)
            cond_dim = txt_encoder.encoding_size
        gen = create_object(args.G, cond_dim=cond_dim)
        discrims = [create_object(d, cond_dim=cond_dim) for d in args.D]
        sample_mapping = create_object(args.M) if args.M else None
    d_names = args.discrim_names or [f"discrim-{i}" for i in range(len(args.D))]
    gan = CondGan(gen, txt_encoder, discrims=discrims, sample_mapping=sample_mapping)

    config = TrainConfig(frame_sizes=tuple(args.frame_sizes), latent_size=gen.latent_size)
    g_params, d_params = optimizer_params(gan, config)
    step = build_train_step(gan, None, adam(g_params, 1e-4, 0.9, 0.999),
                            adam(d_params, 1e-4, 0.9, 0.999), config)
    state = to_host(torch_state_to_jax(step))

    state["g_vars"] = _check("gen", converter_for(gen)(sds["gen"]), state["g_vars"])
    for k, (name, d) in enumerate(zip(d_names, discrims)):
        state["d_vars"][str(k)] = _check(name, converter_for(d)(sds[name]),
                                        state["d_vars"][str(k)])
    if txt_encoder is not None:
        state["txt_vars"] = _check("cond", seq2seq_vars(sds["cond"]), state["txt_vars"])
    if sample_mapping is not None:
        state["m_vars"] = _check("sample_mapping",
                                converter_for(sample_mapping)(sds["sample_mapping"]),
                                state["m_vars"])

    save_state(state, args.out)
    status(f"imported -> {args.out} (fresh optimizer state, step 0); usable with "
           f"--weights in train/sample/serve/eval")
    return args.out


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, help="reference torch checkpoint")
    p.add_argument("--out", required=True, help="output checkpoint")
    p.add_argument("--G", required=True)
    p.add_argument("--D", nargs="+", required=True)
    p.add_argument("--discrim_names", nargs="+", default=None,
                   help="checkpoint keys of the discriminators "
                        "(default discrim-0..N, the original cond_gan.py:13-14)")
    p.add_argument("--M", default=None,
                   help="sample-mapping spec (TCWYT FrameMap) when the reference "
                        "run used --M")
    p.add_argument("--sent", default="txt2vid_tpu.models.txt.Seq2Seq")
    p.add_argument("--vocab", default=None)
    p.add_argument("--vocab_size", type=int, default=None)
    # the JAX CLI shapes a sample batch for its template from these three; the
    # port's template is the modules' own, so only frame_sizes reaches it
    p.add_argument("--frame_sizes", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--num_channels", type=int, default=3)
    p.add_argument("--device", default=None, help="default: cuda")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
