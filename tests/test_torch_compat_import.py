"""The port's importer of the original PyTorch code's checkpoints
(txt2vid_tpu_torch/compat/torch_import.py) against the JAX package's
(txt2vid_tpu/compat/torch_import.py), on the CPU.

The original code is not here, so its state_dicts are written from flax
variables by chip_smoke's original-layout writer (`orig_*`, the inverse of
the converters), with the TCWYT, TGAN and image-GAN parts below. For every
family in converter_for's table, for Seq2Seq and for TGANv2's no_lstm
generator (and at a 2x2 latent plane, where the fc rows are permuted), with
and without nn.DataParallel's `module.` segments, JAX's converter and the
port's give the JAX module's random variables back exactly: that proves the
writer, and the port's copy of the converters. Then both importer CLIs run
on one torch.save'd checkpoint of tiny specs and write the same bytes (a
fresh-optimizer JAX state of the same variables, byte for byte); a wrong
family or a mismatched spec raises in both; and the imported checkpoint
serves (uint8 within 1 of JAX's service, as tests/test_torch_sample.py
holds serving), samples and trains through the port's CLIs.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import (orig_bn, orig_conv, orig_conv_transpose, orig_dense,
                        orig_multiscale_discrim, orig_multiscale_gen, orig_resnet3d, orig_seq2seq,
                        _unpermute)
from test_torch_models import jax_variables, pallas_interpret, random_variables
from test_torch_sample import (FRAME_SIZES, MAX_LEN, SENTENCES, SPEC_D, SPEC_G, SPEC_S,
                               write_jax_run)
from txt2vid_tpu import serve as jax_serve
from txt2vid_tpu.compat import torch_import as jax_import
from txt2vid_tpu.config import create_object as jax_create_object
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import init_state_abstract as jax_init_state_abstract
from txt2vid_tpu.models import img as jax_img
from txt2vid_tpu.models import resnet3d as jax_resnet3d
from txt2vid_tpu.models import tcwyt as jax_tcwyt
from txt2vid_tpu.models import tgan as jax_tgan
from txt2vid_tpu.models import tganv2 as jax_tganv2
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch import config, sample, serve
from txt2vid_tpu_torch.compat import torch_import
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.train import gan as train_gan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------ the original layout of the other families

def orig_tcwyt_gen(v):
    p, s, sd = v["params"], v["batch_stats"], {}
    orig_dense(sd, "input_map.0", p["input_map"])
    orig_bn(sd, "input_map.1", p["input_bn"], s["input_bn"])
    for di, si in enumerate((0, 3, 6, 9, 12)):
        orig_conv_transpose(sd, f"seq.{si}", p[f"dc{di}"])
        if di < 4:
            orig_bn(sd, f"seq.{si + 1}", p[f"bn{di}"], s[f"bn{di}"])
    return sd


def orig_video_discrim(v):
    p, s, sd = v["params"], v["batch_stats"], {}
    for name, si in (("conv0", 0), ("conv1", 2), ("conv2", 5), ("conv3", 8)):
        orig_conv(sd, f"x_map.{si}", p[name])
    for i, si in zip((1, 2, 3), (3, 6, 9)):
        orig_bn(sd, f"x_map.{si}", p[f"bn{i}"], s[f"bn{i}"])
    if "cond_map" in p:
        orig_dense(sd, "cond_map.0", p["cond_map"])
        orig_bn(sd, "cond_map.1", p["cond_bn"], s["cond_bn"])
        orig_conv(sd, "pred.0", p["pred0"])
        orig_bn(sd, "pred.1", p["pred_bn"], s["pred_bn"])
        orig_conv(sd, "pred.3", p["pred1"])
    else:
        orig_conv(sd, "pred", p["pred"])
    return sd


def orig_frame_map(v):
    p, s, sd = v["params"], v["batch_stats"], {}
    for di, si in enumerate((0, 3, 6, 9)):
        orig_conv(sd, f"frame_map.{si}", p[f"conv{di}"])
        if di < 3:
            orig_bn(sd, f"frame_map.{si + 1}", p[f"bn{di}"], s[f"bn{di}"])
    return sd


def orig_sent_head(map_attr):
    def write(v):
        p, s, sd = v["params"]["head"], v["batch_stats"]["head"], {}
        orig_conv(sd, f"{map_attr}.0", p["map"])
        orig_bn(sd, f"{map_attr}.1", p["map_bn"], s["map_bn"])
        orig_conv(sd, "predictor.0", p["pred0"])
        orig_bn(sd, "predictor.1", p["pred_bn"], s["pred_bn"])
        orig_conv(sd, "predictor.3", p["pred1"])
        orig_dense(sd, "sent_map.0", p["sent_map"])
        orig_bn(sd, "sent_map.1", p["sent_bn"], s["sent_bn"])
        return sd
    return write


def orig_tgan_gen(v):
    p, s, sd = v["params"], v["batch_stats"], {}
    for i in range(5):
        orig_conv_transpose(sd, f"_fsgen.dc{i}", p["fsgen"][f"dc{i}"])
        if i < 4:
            orig_bn(sd, f"_fsgen.bn{i}", p["fsgen"][f"bn{i}"], s["fsgen"][f"bn{i}"])
    vg, vs = p["vgen"], s["vgen"]
    half = np.shape(vg["dc1"]["kernel"])[-2] // 2         # conv_ch / 2
    rows = np.shape(vg["l0s"]["kernel"])[1]
    bw = int(round((rows // half) ** 0.5))
    perm = np.arange(rows).reshape(half, bw, bw).transpose(1, 2, 0).reshape(-1)
    for name in ("l0s", "l0f"):
        orig_dense(sd, f"_vgen.{name}", vg[name], perm=perm)
    for name in ("bn0s", "bn0f"):
        orig_bn(sd, f"_vgen.{name}", vg[name], vs[name], perm=perm)
    for i in range(1, 5):
        orig_conv_transpose(sd, f"_vgen.dc{i}", vg[f"dc{i}"])
        orig_bn(sd, f"_vgen.bn{i}", vg[f"bn{i}"], vs[f"bn{i}"])
    orig_conv_transpose(sd, "_vgen.dc5", vg["dc5"])
    return sd


def _img_perm(ch8):
    return np.arange(ch8 * 16).reshape(ch8, 4, 4).transpose(1, 2, 0).reshape(-1)


def orig_img_gen(v):
    p, s, sd = v["params"], v["batch_stats"], {}
    orig_dense(sd, "ln1", p["ln1"], perm=_img_perm(np.shape(p["ln1"]["kernel"])[1] // 16))
    orig_conv(sd, "conv1.conv", p["conv1"])
    orig_bn(sd, "bn", p["bn"], s["bn"])
    for i in range(1, 5):
        rb, rs = p[f"rb{i}"], s[f"rb{i}"]
        orig_conv(sd, f"rb{i}.conv_shortcut.conv.conv", rb["conv_shortcut"])
        orig_conv(sd, f"rb{i}.conv_1.conv.conv", rb["conv1"])
        orig_conv(sd, f"rb{i}.conv_2.conv", rb["conv2"])
        orig_bn(sd, f"rb{i}.bn1", rb["bn1"], rs["bn1"])
        orig_bn(sd, f"rb{i}.bn2", rb["bn2"], rs["bn2"])
    return sd


def orig_img_discrim(v):
    p, sd = v["params"], {}
    orig_conv(sd, "conv1.conv", p["conv1"])
    k = np.asarray(p["ln1"]["kernel"], np.float32)                 # (16 * 8d, 1)
    sd["ln1.weight"] = _unpermute(np.ascontiguousarray(k.T), _img_perm(k.shape[0] // 16))
    sd["ln1.bias"] = np.asarray(p["ln1"]["bias"], np.float32)
    for i in range(1, 5):
        rb = p[f"rb{i}"]
        orig_conv(sd, f"rb{i}.conv_shortcut.conv.conv", rb["conv_shortcut"])
        orig_conv(sd, f"rb{i}.conv_1.conv", rb["conv1"])
        orig_conv(sd, f"rb{i}.conv_2.conv.conv", rb["conv2"])
        for j in (1, 2):           # LayerNorm over (C, H, W), flax's (H, W, C)
            sd[f"rb{i}.bn{j}.weight"] = np.asarray(rb[f"ln{j}"]["scale"]).transpose(2, 0, 1)
            sd[f"rb{i}.bn{j}.bias"] = np.asarray(rb[f"ln{j}"]["bias"]).transpose(2, 0, 1)
    return sd


# ------------------------------------------------------------------ the families

def _z(*shape):
    return jnp.zeros(shape, jnp.float32)


def _scales(b, sizes, t=4, c=3):
    return [_z(b >> i, t >> i if i else t, s, s, c) for i, s in enumerate(sizes)]


GEN = dict(latent_size=8, num_channels=3, fm_channels=16, num_frames=4, cond_dim=8)
# name: (JAX module, its init args, the converter, the writer, the port spec)
FAMILIES = {
    "tganv2_gen": (jax_tganv2.MultiScaleGen(**GEN, width=32, height=32,
                                            additional_blocks=(16, 8), with_non_local=True),
                   (_z(2, 8), _z(2, 8)), "multiscale_gen_vars", orig_multiscale_gen,
                   {"class": "txt2vid_tpu.models.tganv2.MultiScaleGen",
                    "args": {**GEN, "width": 32, "height": 32, "additional_blocks": [16, 8],
                             "with_non_local": True}}),
    "tganv2_gen_2x2": (jax_tganv2.MultiScaleGen(**GEN, width=64, height=64,
                                                additional_blocks=(8, 8)),
                       (_z(2, 8), _z(2, 8)), "multiscale_gen_vars", orig_multiscale_gen, None),
    "no_lstm": (jax_tganv2.MultiScaleGen(**GEN, width=32, height=32, additional_blocks=(8,),
                                         no_lstm=True),
                (_z(2, 8), _z(2, 8)), "multiscale_gen_vars", orig_multiscale_gen, None),
    "no_lstm_2x2": (jax_tganv2.MultiScaleGen(**GEN, width=64, height=64,
                                             additional_blocks=(8, 8), no_lstm=True),
                    (_z(2, 8), _z(2, 8)), "multiscale_gen_vars", orig_multiscale_gen, None),
    "tganv2_discrim": (jax_tganv2.MultiScaleDiscrim(discrim_down_blocks=(1, 2), cond_dim=8),
                       (_scales(4, (8, 16)), [_z(4, 8), _z(2, 8)]), "multiscale_discrim_vars",
                       orig_multiscale_discrim,
                       {"class": "txt2vid_tpu.models.tganv2.MultiScaleDiscrim",
                        "args": {"discrim_down_blocks": [1, 2], "cond_dim": 8}}),
    "tganv2_sub_discrims": (jax_tganv2.MultiScaleDiscrim(discrim_down_blocks=(1, 2),
                                                         single_discrim=False),
                            (_scales(4, (8, 16)),), "multiscale_discrim_vars",
                            orig_multiscale_discrim, None),
    "resnet3d": (jax_resnet3d.Resnet3D(num_down_blocks=2, cond_dim=8),
                 (_z(2, 4, 16, 16, 3), _z(2, 8)), "resnet3d_vars",
                 lambda v: orig_resnet3d({}, "", v["params"]),
                 {"class": "txt2vid_tpu_torch.models.resnet3d.Resnet3D",
                  "args": {"num_down_blocks": 2, "cond_dim": 8}}),
    "tcwyt_gen": (jax_tcwyt.Gen(z_size=6, cond_dim=4, scale_factor=1 / 16), (_z(2, 6), _z(2, 4)),
                  "tcwyt_gen_vars", orig_tcwyt_gen,
                  {"class": "txt2vid_tpu.models.tcwyt.Gen",
                   "args": {"z_size": 6, "cond_dim": 4, "scale_factor": 1 / 16}}),
    "video_discrim": (jax_tcwyt.VideoDiscrim(cond_dim=8, mid_ch=4),
                      (_z(2, 8, 40, 40, 3), _z(2, 8)), "tcwyt_video_discrim_vars",
                      orig_video_discrim,
                      {"class": "txt2vid_tpu.models.tcwyt.VideoDiscrim",
                       "args": {"cond_dim": 8, "mid_ch": 4}}),
    "video_discrim_uncond": (jax_tcwyt.VideoDiscrim(cond_dim=0, mid_ch=4),
                             (_z(2, 8, 40, 40, 3),), "tcwyt_video_discrim_vars",
                             orig_video_discrim, None),
    "frame_map": (jax_tcwyt.FrameMap(), (_z(2, 3, 40, 40, 3),), "tcwyt_frame_map_vars",
                  orig_frame_map, {"class": "txt2vid_tpu.models.tcwyt.FrameMap"}),
    "frame_discrim": (jax_tcwyt.FrameDiscrim(cond_dim=8),
                      (None, _z(2, 8), _z(2, 3, 3, 3, 512)), "tcwyt_frame_discrim_vars",
                      orig_sent_head("frame_map"),
                      {"class": "txt2vid_tpu.models.tcwyt.FrameDiscrim",
                       "args": {"cond_dim": 8}}),
    "motion_discrim": (jax_tcwyt.MotionDiscrim(cond_dim=8),
                       (None, _z(2, 8), _z(2, 3, 3, 3, 512)), "tcwyt_motion_discrim_vars",
                       orig_sent_head("motion_map"),
                       {"class": "txt2vid_tpu.models.tcwyt.MotionDiscrim",
                        "args": {"cond_dim": 8}}),
    "tgan_gen": (jax_tgan.Gen(z_slow_dim=5, z_fast_dim=6, cond_dim=3, conv_ch=32),
                 (_z(3, 5), _z(3, 3)), "tgan_gen_vars", orig_tgan_gen,
                 {"class": "txt2vid_tpu.models.tgan.Gen",
                  "args": {"z_slow_dim": 5, "z_fast_dim": 6, "cond_dim": 3, "conv_ch": 32}}),
    "img_gen": (jax_img.Gen(dim=4), (_z(2, 128),), "img_gen_vars", orig_img_gen,
                {"class": "txt2vid_tpu.models.img.Gen", "args": {"dim": 4}}),
    "img_discrim": (jax_img.Discrim(dim=4), (_z(2, 64, 64, 3),), "img_discrim_vars",
                    orig_img_discrim, {"class": "txt2vid_tpu.models.img.Discrim",
                                       "args": {"dim": 4}}),
    "seq2seq": (JaxSeq2Seq(vocab_size=11, embed_size=8, hidden_size=16, num_layers=2),
                (jnp.ones((2, 5), jnp.int32), jnp.full((2,), 5, jnp.int32)), "seq2seq_vars",
                orig_seq2seq, None),
}


@pytest.fixture(scope="module")
def family_vars():
    """name -> the JAX module's random variables (shapes from eval_shape)."""
    out = {}
    for i, (name, (module, args, *_)) in enumerate(FAMILIES.items()):
        if name in ("frame_discrim", "motion_discrim"):
            args, kwargs = (), {"cond": args[1], "xbar": args[2], "train": True}
        else:
            kwargs = {} if name in ("seq2seq", "img_discrim") else {"train": True}
        out[name] = jax_variables(module, 100 + i, *args, **kwargs)
    return out


def _assert_tree_equal(got, want, where=""):
    assert isinstance(got, dict) == isinstance(want, dict), where
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)
    assert np.asarray(got).dtype == np.float32, where


@pytest.mark.parametrize("data_parallel", [False, True], ids=["plain", "module"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_converters_invert_the_writer(family_vars, name, data_parallel):
    """The original-layout state_dict of the JAX module's variables, through
    JAX's converter and the port's: the variables exactly. With `module`,
    the keys as nn.DataParallel writes them: TGANv2's sub-discriminators
    wrapped (`single_discrim.module.`, as the original discriminator wraps
    them), every other model wrapped whole (`module.`)."""
    _, _, conv, write, _ = FAMILIES[name]
    want = family_vars[name]
    if data_parallel and write is orig_multiscale_discrim:
        sd = orig_multiscale_discrim(want, data_parallel=True)
        assert any(".module." in k for k in sd)
    else:
        sd = write(want)
        if data_parallel:
            sd = {f"module.{k}": v for k, v in sd.items()}
    for pkg in (jax_import, torch_import):
        _assert_tree_equal(getattr(pkg, conv)(dict(sd)), want, f"{pkg.__name__} {name}")


@pytest.mark.parametrize("name", [n for n, f in FAMILIES.items() if f[4] is not None])
def test_converter_for_dispatches_like_jax(name):
    """converter_for on the port's module picks the function of the same name
    as JAX's on the JAX module (the tganv2_cond partials as tganv2's)."""
    module, _, conv, _, spec = FAMILIES[name]
    port = config.create_object(spec)
    assert torch_import.converter_for(port) is getattr(torch_import, conv)
    assert jax_import.converter_for(module) is getattr(jax_import, conv)
    cond = config.create_object("txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
                                latent_size=4, fm_channels=8, additional_blocks=[8])
    assert torch_import.converter_for(cond) is torch_import.multiscale_gen_vars


def test_converter_for_rejects_a_module_it_has_no_converter_for():
    from txt2vid_tpu_torch.models.txt import Seq2Seq
    with pytest.raises(NotImplementedError, match="txt.Seq2Seq"):
        torch_import.converter_for(Seq2Seq(vocab_size=5))


def test_strip_data_parallel_and_missing_key():
    sd = {"module.a.module.b": 1, "c.module.d": 2, "e": 3}
    want = {"a.b": 1, "c.d": 2, "e": 3}
    assert torch_import.strip_data_parallel(sd) == jax_import.strip_data_parallel(sd) == want
    for pkg in (jax_import, torch_import):
        with pytest.raises(pkg.MissingKey, match="fc.weight"):
            pkg.multiscale_gen_vars({"clstm.cell0.Wxi.weight": np.zeros((4, 4, 3, 3))})


# ------------------------------------------------------------- the importer CLIs

def _save_original(path, entries):
    """The original trainer's flat torch.save dict, optimizer entries too."""
    opt = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2))])
    torch.save({"optG": opt.state_dict(), "optD": opt.state_dict(),
                **{k: {n: torch.from_numpy(np.array(v)) for n, v in sd.items()}
                   for k, sd in entries.items()}}, path)


def _import_args(ckpt, out, G, D, **kw):
    base = dict(ckpt=str(ckpt), out=str(out), G=G, D=D, discrim_names=None, M=None,
                sent="txt2vid_tpu.models.txt.Seq2Seq", vocab=None, vocab_size=None,
                frame_sizes=list(FRAME_SIZES), num_frames=4, num_channels=1)
    base.update(kw)
    return base


def _port_argv(a):
    argv = ["--ckpt", a["ckpt"], "--out", a["out"], "--G", a["G"], "--D", *a["D"],
            "--sent", a["sent"], "--frame_sizes", *map(str, a["frame_sizes"]),
            "--num_frames", str(a["num_frames"]), "--num_channels", str(a["num_channels"]),
            "--device", "cpu"]
    for flag in ("vocab", "vocab_size", "M"):
        if a[flag] is not None:
            argv += [f"--{flag}", str(a[flag])]
    return argv


@pytest.fixture(scope="module")
def cond_run(tmp_path_factory):
    """test_torch_sample's tiny JAX run (random G, D and encoder variables,
    fresh optimizer state) written in the original layout, D's keys with
    DataParallel's segments, and imported by both packages."""
    root = tmp_path_factory.mktemp("cond")
    run = write_jax_run(root, seed=11)
    state = jax.tree_util.tree_map(np.asarray, run["state"])
    ckpt = root / "ref_iter_100_lossG_0.7_lossD_0.7"
    _save_original(ckpt, {"gen": orig_multiscale_gen(state.g_vars),
                          "cond": orig_seq2seq(state.txt_vars),
                          "discrim-0": orig_multiscale_discrim(state.d_vars[0],
                                                               data_parallel=True)})
    a = _import_args(ckpt, root / "jax_imported", json.dumps(SPEC_G), [json.dumps(SPEC_D)],
                     sent=json.dumps(SPEC_S), vocab=run["vocab"])
    jax_import.main(argparse.Namespace(**a))
    b = dict(a, out=str(root / "port_imported"))
    assert torch_import.cli(_port_argv(b)) == b["out"]
    return dict(run, root=root, ckpt=ckpt, args=a, jax=a["out"], port=b["out"])


def test_cli_checkpoints_match_byte_for_byte(cond_run):
    """Both importers write the same bytes, and they are the JAX state the
    original checkpoint was written from (random variables, zero moments,
    step 0) as the JAX package saves it."""
    with open(cond_run["jax"], "rb") as f, open(cond_run["port"], "rb") as g:
        data = f.read()
        assert data == g.read()
    with open(cond_run["weights"], "rb") as f:
        assert f.read() == data


def test_cli_tcwyt_with_sample_mapping(tmp_path):
    """run.sh's family (TCWYT G, video/frame/motion discriminators, the --M
    FrameMap, the encoder) at 48 px: both importers, one set of bytes."""
    cd = 16
    gspec = json.dumps({"class": "txt2vid_tpu.models.tcwyt.Gen",
                        "args": {"z_size": 6, "num_channels": 3, "scale_factor": 1 / 16}})
    dspecs = [json.dumps({"class": "txt2vid_tpu.models.tcwyt.VideoDiscrim",
                          "args": {"mid_ch": 4}}),
              "txt2vid_tpu.models.tcwyt.FrameDiscrim", "txt2vid_tpu.models.tcwyt.MotionDiscrim"]
    mspec, sspec = "txt2vid_tpu.models.tcwyt.FrameMap", json.dumps(SPEC_S)
    txt = jax_create_object(sspec, vocab_size=13)
    gan = JaxCondGan(gen=jax_create_object(gspec, cond_dim=cd),
                     discrims=[jax_create_object(d, cond_dim=cd) for d in dspecs],
                     cond_encoder=txt, sample_mapping=jax_create_object(mspec))
    batch = {"video": jnp.zeros((2, 16, 48, 48, 3), jnp.float32),
             "captions": jnp.ones((2, 8), jnp.int32), "lengths": jnp.full((2,), 8, jnp.int32)}
    opt = optax.adam(1e-4)
    state = jax_init_state_abstract(gan, jax.random.key(0), batch, opt, opt,
                                    JaxTrainConfig(frame_sizes=(48,), latent_size=6))
    rng = np.random.default_rng(5)
    rand = lambda t: random_variables(jax.tree_util.tree_map(np.asarray, t), rng)
    state = state.replace(g_vars=rand(state.g_vars), d_vars=tuple(rand(d) for d in state.d_vars),
                          txt_vars=rand(state.txt_vars), m_vars=rand(state.m_vars))
    ckpt = tmp_path / "ref_tcwyt"
    _save_original(ckpt, {"gen": orig_tcwyt_gen(state.g_vars), "cond": orig_seq2seq(state.txt_vars),
                          "sample_mapping": orig_frame_map(state.m_vars),
                          "discrim-0": orig_video_discrim(state.d_vars[0]),
                          "discrim-1": orig_sent_head("frame_map")(state.d_vars[1]),
                          "discrim-2": orig_sent_head("motion_map")(state.d_vars[2])})
    a = _import_args(ckpt, tmp_path / "jax", gspec, dspecs, M=mspec, sent=sspec, vocab_size=13,
                     frame_sizes=[48], num_frames=16, num_channels=3)
    jax_import.main(argparse.Namespace(**a))
    b = dict(a, out=str(tmp_path / "port"))
    torch_import.cli(_port_argv(b))
    jax_checkpoint.save_state(state, str(tmp_path / "state"))
    data = (tmp_path / "jax").read_bytes()
    assert data == (tmp_path / "port").read_bytes() == (tmp_path / "state").read_bytes()


@pytest.mark.parametrize("case", ["family", "shape", "structure"])
def test_a_mismatched_spec_raises_in_both(cond_run, case, tmp_path):
    """A generator of another family (a missing key in its converter), one of
    another width (a shape) and a discriminator of another depth (a path)
    raise in both importers, naming the entry; neither writes a file."""
    g, d = dict(SPEC_G), dict(SPEC_D)
    if case == "family":
        g = {"class": "txt2vid_tpu.models.tcwyt.Gen", "args": {"z_size": 16}}
        errors, match = (KeyError, AssertionError), "state_dict is missing"
    elif case == "shape":
        g = {**g, "args": {**g["args"], "fm_channels": 16}}
        errors, match = (AssertionError,), "gen: shape"
    else:
        d = {**d, "args": {**d["args"], "discrim_down_blocks": [1, 1, 2]}}
        errors, match = (AssertionError,), "discrim-0: imported tree mismatches"
    a = _import_args(cond_run["ckpt"], tmp_path / "jax", json.dumps(g), [json.dumps(d)],
                     sent=json.dumps(SPEC_S), vocab=cond_run["vocab"])
    with pytest.raises(errors, match=match):
        jax_import.main(argparse.Namespace(**a))
    port_errors = (KeyError,) if case == "family" else (ValueError,)
    with pytest.raises(port_errors, match=match):
        torch_import.cli(_port_argv(dict(a, out=str(tmp_path / "port"))))
    assert not (tmp_path / "jax").exists() and not (tmp_path / "port").exists()


def _serve_argv(run, weights, out, *extra):
    return ["--weights", weights, "--G", json.dumps(SPEC_G), "--D", json.dumps(SPEC_D),
            "--sent", json.dumps(SPEC_S), "--vocab", run["vocab"],
            "--frame_sizes", *map(str, FRAME_SIZES), "--num_frames", "4", "--num_channels", "1",
            "--out_samples", str(out), "--sentences", *SENTENCES, "--seed", "2", *extra]


def test_imported_checkpoint_serves_like_jax(cond_run, tmp_path, monkeypatch):
    """The port's serve from the port's import against JAX's serve from JAX's,
    with each chunk's JAX z: uint8 within one level; `sample` reads it too."""
    extra = ("--batch_size", "2", "--max_caption_len", str(MAX_LEN))
    with pallas_interpret():
        svc = jax_serve.GeneratorService.from_checkpoint(
            cond_run["jax"], json.dumps(SPEC_G), [json.dumps(SPEC_D)], sent=json.dumps(SPEC_S),
            vocab_path=cond_run["vocab"], frame_sizes=FRAME_SIZES, num_frames=4,
            num_channels=1, batch_size=2, max_caption_len=MAX_LEN)
        ref = svc.generate(sentences=SENTENCES, seed=2)
    monkeypatch.setattr(serve.GeneratorService, "_draw_z", lambda self, s, i: jax.random.normal(
        jax.random.fold_in(jax.random.key(s), i), (self.batch_size, 16)))
    got = serve.cli(_serve_argv(cond_run, cond_run["port"], tmp_path / "serve",
                                "--device", "cpu", *extra))
    assert got.shape == ref.shape == (3, 4, 32, 32, 1) and ref.std() > 1.0
    assert int(np.abs(got.astype(int) - np.asarray(ref).astype(int)).max()) <= 1
    fakes = sample.cli(_serve_argv(cond_run, cond_run["port"], tmp_path / "sample",
                                   "--device", "cpu"))
    assert fakes.shape == (3, 4, 32, 32, 1) and bool(np.isfinite(fakes).all())


def test_imported_checkpoint_trains(cond_run, tmp_path):
    """The training CLI's --weights from the imported checkpoint: the
    variables as imported at the start, one finite step, a checkpoint."""
    data = tmp_path / "data"
    generate_examples(data / "videos", data / "sent.pickle", num_examples=4,
                      frame_size=(32, 32), num_frames=4, seed=3, num_channels=1)
    spec = {"class": "txt2vid_tpu.data.my_dataset",
            "args": {"data": str(data / "videos"), "num_frames": 4}}
    out = tmp_path / "out"
    train_gan.cli(["--device", "cpu", "--weights", cond_run["port"],
                   "--G", json.dumps(SPEC_G), "--D", json.dumps(SPEC_D),
                   "--sent", json.dumps(SPEC_S), "--data", json.dumps(spec),
                   "--anno", str(data / "sent.pickle"), "--vocab", cond_run["vocab"],
                   "--frame_sizes", *map(str, FRAME_SIZES), "--subsample_input",
                   "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--batch_size", "4",
                   "--epochs", "1", "--seed", "1", "--workers", "1",
                   "--save_model_period", "1", "--out", str(out),
                   "--out_samples", str(out / "samples")])
    saved = [p for p in out.iterdir() if p.name.startswith("iter_1_")]
    assert len(saved) == 1
    loss_g, loss_d = (float(x) for x in saved[0].name.split("_")[3::2])
    assert np.isfinite(loss_g) and np.isfinite(loss_d)
