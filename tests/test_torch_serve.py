"""The serving slice of txt2vid_tpu_torch against the JAX GeneratorService.

The JAX service runs the small conditional model with the Pallas attention in
interpret mode; the port runs the same variables, carried over with
txt2vid_tpu_torch.convert, on the CPU. The port draws z with a torch.Generator,
so the test reproduces the JAX service's z for each chunk and feeds it to the
port's `_run(toks, lens, z)`. Tolerances: the float video 1e-4 (every conv,
the LSTMs and the attention sum in other orders); uint8 equal, except a
difference of 1 where the float lies within 1e-3 of a rounding boundary.
"""

import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cli import D as CLI_D
from test_torch_cli import G as CLI_G
from test_torch_cli import S as CLI_S
from test_torch_cli import argv as cli_argv
from test_torch_cli import data  # noqa: F401  (the fixture)
from test_torch_models import (SMALL_GEN, assert_close, jax_variables, pallas_interpret,
                               random_variables)
from txt2vid_tpu.config import create_object as jax_create_object
from txt2vid_tpu.data import Vocab as JaxVocab
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import init_state as jax_init_state
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.serve import GeneratorService as JaxService
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch import config, serve
from txt2vid_tpu_torch.utils import video
from txt2vid_tpu_torch.convert import (jax_to_torch_encoder, jax_to_torch_generator,
                                       load_encoder_vars, torch_to_jax_discriminator,
                                       torch_to_jax_encoder, torch_to_jax_generator)
from txt2vid_tpu_torch.data import load_pickle
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.serve import GeneratorService
from txt2vid_tpu_torch.train import gan as train_gan
from txt2vid_tpu_torch.utils import checkpoint, msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, MAX_LEN = 4, 10
ENC = dict(embed_size=8, hidden_size=16, num_layers=2)
GEN_CONFIG = {**SMALL_GEN, "with_non_local": True}
# the same models as specs written for the JAX package
SPEC_G = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
          "args": {k: v for k, v in SMALL_GEN.items() if k != "cond_dim"} | {"use_pallas": False}}
SPEC_D = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
          "args": {"discrim_down_blocks": [1, 1, 1], "num_channels": 3, "use_pallas": False}}
SPEC_S = {"class": "txt2vid_tpu.models.txt.Seq2Seq", "args": ENC}
WORDS = ["digit", "is", "moving", "left", "right", "up", "down", "and"] + \
    [str(i) for i in range(10)]
# mixed lengths, all shorter than MAX_LEN once <start>/<end> are added
SENTENCES = ["digit 3 is moving left and right.", "digit 7.", "digit 1 is up.",
             "digit 0 is moving down and up.", "digit 5 left."]


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    """(JAX service, port service, pickled vocab path) over the same variables."""
    vocab = JaxVocab()
    for w in WORDS:
        vocab.add_word(w)
    vocab_path = str(tmp_path_factory.mktemp("vocab") / "vocab.pickle")
    with open(vocab_path, "wb") as f:
        pickle.dump(vocab, f)

    gen = jax_tganv2_cond.MultiScaleGen(**SMALL_GEN, use_pallas=True)
    enc = JaxSeq2Seq(vocab_size=len(vocab), **ENC)
    g_vars = jax_variables(gen, 20, jnp.zeros((4, 16)), jnp.zeros((4, 16)), train=True)
    txt_vars = jax_variables(enc, 21, jnp.ones((BATCH, MAX_LEN), jnp.int32),
                             jnp.full((BATCH,), MAX_LEN, jnp.int32))
    gan = JaxCondGan(gen=gen, discrims=[jax_tganv2_cond.MultiScaleDiscrim(cond_dim=16)],
                     cond_encoder=enc)
    state = types.SimpleNamespace(g_vars=g_vars, txt_vars=txt_vars)
    jax_service = JaxService(gan, state, vocab=vocab, batch_size=BATCH,
                             max_caption_len=MAX_LEN)

    port_gen = tganv2.MultiScaleGen(**GEN_CONFIG)
    port_gen.load_state_dict(jax_to_torch_generator(g_vars["params"],
                                                    g_vars["batch_stats"]))
    port_enc = Seq2Seq(vocab_size=len(vocab), **ENC)
    port_enc.load_state_dict(jax_to_torch_encoder(txt_vars["params"]))
    port_service = GeneratorService(CondGan(port_gen, port_enc),
                                    vocab=load_pickle(vocab_path), batch_size=BATCH,
                                    max_caption_len=MAX_LEN, device="cpu")
    return jax_service, port_service, vocab_path


class TestSliceAgainstJax:
    def test_video_matches_jax_service(self, slice_pair):
        jax_service, port, _ = slice_pair
        with pallas_interpret():
            _assert_matches_jax_service(jax_service, port, seed=3)


def _assert_matches_jax_service(jax_service, port, seed):
    """The port's service against the JAX service on SENTENCES: the float
    video of each chunk at JAX's z (1e-4 of the scale) and the uint8 videos
    (equal, or 1 apart within 1e-3 of a rounding boundary)."""
    ref_u8 = jax_service.generate(sentences=SENTENCES, seed=seed)
    gan, state = jax_service.gan, jax_service.state
    latent = gan.gen.latent_size

    def jax_video(toks, lens, key):
        z = jax.random.normal(key, (BATCH, latent))
        cond = gan.encode(state.txt_vars, toks, lens)
        return gan.generate(state.g_vars, z, cond=cond, train=False)[-1], z

    floats, u8s = [], []
    for i, (toks, lens) in enumerate(port._chunks(SENTENCES)[1]):
        key = jax.random.fold_in(jax.random.key(seed), i)
        ref, z = jax.jit(jax_video)(jnp.asarray(toks, jnp.int32),
                                    jnp.asarray(lens, jnp.int32), key)
        got = port._video(toks, lens, np.array(z))
        scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
        assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= 1e-4 * scale
        floats.append(np.asarray(ref))
        u8s.append(port._run(toks, lens, np.array(z)).numpy())
    ref_f = np.concatenate(floats)[:len(SENTENCES)]
    got_u8 = np.concatenate(u8s)[:len(SENTENCES)]

    assert got_u8.dtype == np.uint8 and got_u8.shape == ref_u8.shape == (5, 4, 32, 32, 3)
    diff = got_u8.astype(np.int16) - ref_u8.astype(np.int16)
    scaled = (ref_f.astype(np.float64) + 1.0) * 127.5
    near_boundary = np.abs(scaled - np.round(scaled)) <= 1e-3 * 127.5
    assert np.all((diff == 0) | ((np.abs(diff) == 1) & near_boundary))
    # the video is not constant: the comparison above saw real content
    assert ref_u8.std() > 5


class TestPortService:
    def test_chunk_and_pad(self, slice_pair):
        _, port, _ = slice_pair
        out = port.generate(sentences=SENTENCES, seed=5)
        assert out.shape == (5, 4, 32, 32, 3) and out.dtype == np.uint8
        n, chunks = port._chunks(SENTENCES)
        assert n == 5 and len(chunks) == 2
        toks, lens = chunks[1]
        assert toks.shape == (BATCH, MAX_LEN) and list(lens[1:]) == [1, 1, 1]
        assert not toks[1:].any()
        runs = [port._run(t, l, port._draw_z(5, i)).numpy() for i, (t, l) in enumerate(chunks)]
        np.testing.assert_array_equal(out, np.concatenate(runs)[:5])

    def test_deterministic_and_seed_sensitive(self, slice_pair):
        _, port, _ = slice_pair
        a = port.generate(sentences=SENTENCES[:2], seed=3)
        b = port.generate(sentences=SENTENCES[:2], seed=3)
        c = port.generate(sentences=SENTENCES[:2], seed=4)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_unconditional_num(self, slice_pair):
        _, port, _ = slice_pair
        assert port.generate(num=3, seed=1).shape == (3, 4, 32, 32, 3)

    def test_checkpoint_round_trip(self, slice_pair, tmp_path):
        """The service's models written as a training checkpoint (the train
        state's g_vars, d_vars and txt_vars, as the trainer writes them) and
        served from it give the same videos."""
        _, port, vocab_path = slice_pair
        disc = tganv2.MultiScaleDiscrim(discrim_down_blocks=(1, 1, 1), cond_dim=16)
        state = {"step": np.array(3, np.int32),
                 "g_vars": dict(zip(("params", "batch_stats"),
                                    torch_to_jax_generator(port.gan.gen.state_dict()))),
                 "d_vars": {"0": {"params": torch_to_jax_discriminator(disc.state_dict())}},
                 "txt_vars": {"params": torch_to_jax_encoder(
                     port.gan.cond_encoder.state_dict())}}
        path = tmp_path / "iter_3_lossG_1.0000_lossD_1.0000"
        checkpoint.save_state(state, path)
        loaded = GeneratorService.from_checkpoint(
            str(path), SPEC_G, [SPEC_D], sent=SPEC_S, vocab_path=vocab_path,
            frame_sizes=(8, 16, 32), num_frames=4, num_channels=3, batch_size=BATCH,
            max_caption_len=MAX_LEN, device="cpu")
        np.testing.assert_array_equal(loaded.generate(sentences=SENTENCES, seed=2),
                                      port.generate(sentences=SENTENCES, seed=2))
        with pytest.raises(ValueError, match="renders"):
            GeneratorService.from_checkpoint(str(path), SPEC_G, [SPEC_D], sent=SPEC_S,
                                             vocab_path=vocab_path, frame_sizes=(16, 64),
                                             num_frames=4, num_channels=3, device="cpu")
        with pytest.raises(FileNotFoundError, match=".ema"):
            GeneratorService.from_checkpoint(str(path), SPEC_G, [SPEC_D], sent=SPEC_S,
                                             vocab_path=vocab_path, frame_sizes=(8, 16, 32),
                                             num_frames=4, num_channels=3, ema=True,
                                             device="cpu")

    def test_cli_bench(self, monkeypatch, capsys):
        """The CLI's --bench path, with the flagship swapped for the small model."""
        from functools import partial
        monkeypatch.setattr(serve.tganv2_cond, "MultiScaleGen",
                            partial(tganv2.MultiScaleGen, **GEN_CONFIG))
        monkeypatch.setattr(serve, "Seq2Seq", partial(Seq2Seq, **ENC))
        serve.cli(["--bench", "5", "--batch_size", "4", "--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metric"] == "serve_videos_per_sec" and line["value"] > 0
        assert line["shape"] == [4, 32, 32, 3] and line["cond"] is True

    @pytest.mark.parametrize("flags,what", [
        (["--format", "gif"], "--format gif"), (["--format", "mp4"], "--format mp4")])
    def test_cli_flags_not_in_the_port_raise(self, flags, what, monkeypatch, tmp_path):
        """The video formats write one clip per sample (utils/video.py): a GIF
        that PIL decodes to the served frames; mp4 through OpenCV, which
        raises an ImportError naming .gif where cv2 is absent. --weights
        without the specs raises."""
        import io
        from functools import partial
        from PIL import Image, ImageSequence
        monkeypatch.setattr(serve.tganv2_cond, "MultiScaleGen",
                            partial(tganv2.MultiScaleGen, **GEN_CONFIG))
        monkeypatch.setattr(serve, "Seq2Seq", partial(Seq2Seq, **ENC))
        argv = ["--device", "cpu", "--num_samples", "2", "--batch_size", "2",
                "--out_samples", str(tmp_path), *flags]
        if what == "--format gif":
            out = serve.cli(argv)
            for i, v in enumerate(out):
                im = Image.open(io.BytesIO((tmp_path / f"serve_{i}.gif").read_bytes()))
                frames = np.stack([np.asarray(f.convert("RGB"))
                                   for f in ImageSequence.Iterator(im)])
                assert frames.shape == v.shape
                assert int(np.abs(frames.astype(int) - v).max()) <= video.RGB_MAX_ERROR
        else:
            monkeypatch.setitem(sys.modules, "cv2", None)
            with pytest.raises(ImportError, match=r"\.gif"):
                serve.cli(argv)
        with pytest.raises(ValueError, match="--G and --D"):
            serve.cli(["--device", "cpu", "--weights", "iter_1"])


def test_cli_serves_bf16(trained_run, data, tmp_path):
    """--bf16 serves the trainer's checkpoint with a bf16 generator (float32
    parameters and caption encoder): its uint8 videos within 3 levels of the
    float32 service's, the same z and captions."""
    argv = ["--device", "cpu", "--weights", trained_run, "--G", json.dumps(CLI_G),
            "--D", json.dumps(CLI_D), "--sent", json.dumps(CLI_S),
            "--vocab", str(data / "vocab.pickle"), "--frame_sizes", "8", "16",
            "--num_frames", "4", "--num_channels", "3", "--batch_size", "2",
            "--num_samples", "3", "--out_samples", str(tmp_path)]
    made = []
    orig = GeneratorService.from_checkpoint.__func__
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GeneratorService, "from_checkpoint",
                   classmethod(lambda cls, *a, **k: made.append(orig(cls, *a, **k)) or made[-1]))
        out = serve.cli(argv + ["--bf16"])
        ref = serve.cli(argv)
    svc = made[0]
    assert svc.gan.gen.dtype == torch.bfloat16 and made[1].gan.gen.dtype is None
    assert all(p.dtype == torch.float32 for m in (svc.gan.gen, svc.gan.cond_encoder)
               for p in m.parameters())
    toks, lens = svc._chunks(SENTENCES)[1][0]
    assert svc._video(toks, lens, np.zeros((2, 16), np.float32)).dtype == torch.bfloat16
    assert out.dtype == np.uint8 and out.shape == ref.shape == (3, 4, 16, 16, 3)
    assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= 3
    assert not np.array_equal(out, ref)


def _reference_video(tree, ema_tree, vocab, toks, lens, z):
    """The eval-mode generator and encoder of a checkpoint tree, loaded by
    hand (the EMA parameters over the live ones when given), at a pinned z."""
    gen = config.create_object(CLI_G, cond_dim=16).eval()
    gen.load_state_dict(jax_to_torch_generator(tree["g_vars"]["params"],
                                               tree["g_vars"]["batch_stats"]))
    if ema_tree is not None:
        gen.load_state_dict(jax_to_torch_generator(ema_tree), strict=False)
    enc = config.create_object(CLI_S, vocab_size=len(vocab)).eval()
    with torch.no_grad():
        load_encoder_vars(enc, tree["txt_vars"])
        cond = enc.encode(torch.as_tensor(toks), torch.as_tensor(lens))[2]
        return gen(torch.as_tensor(z), cond=cond)[-1]


@pytest.fixture(scope="module")
def trained_run(data, tmp_path_factory):
    """A checkpoint and its .ema that the port's training CLI wrote
    (--device cpu --g_ema 0.999, one epoch of 4 steps)."""
    out = tmp_path_factory.mktemp("served_run")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_gan.cli(cli_argv(data, out, "--epochs", "1"))
    finally:
        torch.set_num_threads(n)
    return checkpoint.latest_checkpoint(out)


class TestServesTrainingCheckpoints:
    @pytest.mark.parametrize("ema", [False, True], ids=["live", "ema"])
    def test_a_checkpoint_the_trainer_wrote(self, trained_run, data, tmp_path, ema):
        assert Path(trained_run).name.startswith("iter_4_")
        argv = ["--device", "cpu", "--weights", trained_run, "--G", json.dumps(CLI_G),
                "--D", json.dumps(CLI_D), "--sent", json.dumps(CLI_S),
                "--vocab", str(data / "vocab.pickle"), "--frame_sizes", "8", "16",
                "--num_frames", "4", "--num_channels", "3", "--batch_size", "2",
                "--num_samples", "3", "--out_samples", str(tmp_path)]
        made = []
        orig = GeneratorService.from_checkpoint.__func__

        def recording(cls, *a, **k):
            made.append(orig(cls, *a, **k))
            return made[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(GeneratorService, "from_checkpoint", classmethod(recording))
            out = serve.cli(argv + (["--ema"] if ema else []))
        assert out.shape == (3, 4, 16, 16, 3) and out.dtype == np.uint8
        assert sorted(p.name for p in tmp_path.iterdir()) == [f"serve_{i}.png" for i in range(3)]
        assert (tmp_path / "serve_0.png").read_bytes().startswith(b"\x89PNG")
        svc = made[0]
        with open(trained_run, "rb") as f:
            tree = msgpack.unpackb(f.read())
        with open(trained_run + ".ema", "rb") as f:
            ema_tree = msgpack.unpackb(f.read())
        toks, lens = svc._chunks(SENTENCES)[1][0]
        z = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)
        got = svc._video(toks, lens, z)
        want = _reference_video(tree, ema_tree if ema else None, svc.vocab, toks, lens, z)
        other = _reference_video(tree, None if ema else ema_tree, svc.vocab, toks, lens, z)
        assert_close(want.numpy(), got, 1e-6, "video")
        # the live and the averaged generators differ, so the check tells them apart
        assert float((want - other).abs().max()) > 1e-3

    def test_a_jax_written_checkpoint(self, slice_pair, tmp_path):
        """A JAX init_state file, its generator and encoder variables
        randomised (the init's zero gammas and unit statistics render a
        constant video), served by JAX's GeneratorService.from_checkpoint and
        by the port's."""
        _, _, vocab_path = slice_pair
        vocab = load_pickle(vocab_path)
        txt = jax_create_object(SPEC_S, vocab_size=len(vocab))
        gan = JaxCondGan(gen=jax_create_object(SPEC_G, cond_dim=16),
                         discrims=[jax_create_object(SPEC_D, cond_dim=16)], cond_encoder=txt)
        rng = np.random.default_rng(6)
        batch = {"video": jnp.asarray(rng.uniform(-1, 1, (BATCH, 4, 32, 32, 3)), jnp.float32),
                 "captions": jnp.ones((BATCH, MAX_LEN), jnp.int32),
                 "lengths": jnp.full((BATCH,), MAX_LEN, jnp.int32)}
        opt = optax.adam(1e-4)
        state = jax_init_state(gan, jax.random.key(7), batch, opt, opt,
                               JaxTrainConfig(frame_sizes=(8, 16, 32), latent_size=16))
        rng = np.random.default_rng(6)
        state = state.replace(
            g_vars=jax.tree_util.tree_map(jnp.asarray, random_variables(state.g_vars, rng)),
            txt_vars=jax.tree_util.tree_map(jnp.asarray, random_variables(state.txt_vars, rng)))
        path = str(tmp_path / "iter_0_lossG_0.0000_lossD_0.0000")
        jax_checkpoint.save_state(state, path)
        kw = dict(sent=SPEC_S, vocab_path=vocab_path, frame_sizes=(8, 16, 32), num_frames=4,
                  num_channels=3, batch_size=BATCH, max_caption_len=MAX_LEN)
        jax_service = JaxService.from_checkpoint(path, SPEC_G, [SPEC_D], **kw)
        port = GeneratorService.from_checkpoint(path, SPEC_G, [SPEC_D], device="cpu", **kw)
        _assert_matches_jax_service(jax_service, port, seed=4)


def _run_python(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


class TestStandsAlone:
    def test_jax_pickled_vocab_loads_without_the_jax_package(self, slice_pair):
        _, _, vocab_path = slice_pair
        code = (
            "import sys\n"
            "from txt2vid_tpu_torch.data import Vocab, load_pickle\n"
            f"v = load_pickle({vocab_path!r})\n"
            "assert type(v) is Vocab, type(v)\n"
            "print(sorted(v.word2idx.items()))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('txt2vid_tpu', 'jax', 'flax')]\n"
            "assert not bad, bad\n")
        res = _run_python(code)
        assert res.returncode == 0, res.stderr
        with open(vocab_path, "rb") as f:
            ref = pickle.load(f)
        assert res.stdout.strip() == str(sorted(ref.word2idx.items()))

    def test_package_imports_no_jax(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import txt2vid_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'txt2vid_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'PIL', 'txt2vid_tpu')]\n"
            "assert not bad, bad\n"
            "print(' '.join(names))\n")
        res = _run_python(code)
        assert res.returncode == 0, res.stderr
        names = set(res.stdout.split())
        assert len(names) >= 38
        # the training slice's modules, the port's bench included, and the
        # training CLI's: trainer, EMA, checkpoints and their codec, config,
        # setup, data
        assert {f"txt2vid_tpu_torch.{m}" for m in (
            "bench", "gan.train_step", "gan.losses", "gan.cond_gan", "models.resnet3d",
            "ops.subsample", "utils.misc", "gan.trainer", "gan.ema", "train.gan",
            "train.setup", "config", "utils.checkpoint", "utils.msgpack", "utils.writer",
            "utils.logging", "utils.metrics", "utils.stopwatch", "data.synthetic",
            "data.__main__", "data.packed", "serve")} <= names
