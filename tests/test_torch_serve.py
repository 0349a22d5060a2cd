"""The serving slice of txt2vid_tpu_torch against the JAX GeneratorService.

The JAX service runs the small conditional model with the Pallas attention in
interpret mode; the port runs the same variables, carried over with
txt2vid_tpu_torch.convert, on the CPU. The port draws z with a torch.Generator,
so the test reproduces the JAX service's z for each chunk and feeds it to the
port's `_run(toks, lens, z)`. Tolerances: the float video 1e-4 (every conv,
the LSTMs and the attention sum in other orders); uint8 equal, except a
difference of 1 where the float lies within 1e-3 of a rounding boundary.
"""

import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import SMALL_GEN, jax_variables, pallas_interpret
from txt2vid_tpu.data import Vocab as JaxVocab
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.serve import GeneratorService as JaxService
from txt2vid_tpu_torch.convert import jax_to_torch_encoder, jax_to_torch_generator
from txt2vid_tpu_torch.data import load_pickle
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.serve import GeneratorService, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, MAX_LEN = 4, 10
ENC = dict(embed_size=8, hidden_size=16, num_layers=2)
GEN_CONFIG = {**SMALL_GEN, "with_non_local": True}
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
        seed = 3
        with pallas_interpret():
            ref_u8 = jax_service.generate(sentences=SENTENCES, seed=seed)
        gan, state = jax_service.gan, jax_service.state

        def jax_video(toks, lens, key):
            z = jax.random.normal(key, (BATCH, SMALL_GEN["latent_size"]))
            cond = gan.encode(state.txt_vars, toks, lens)
            return gan.generate(state.g_vars, z, cond=cond, train=False)[-1], z

        floats, u8s = [], []
        for i, (toks, lens) in enumerate(port._chunks(SENTENCES)[1]):
            key = jax.random.fold_in(jax.random.key(seed), i)
            with pallas_interpret():
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
        _, port, vocab_path = slice_pair
        path = str(tmp_path / "serve.pt")
        save_checkpoint(path, GEN_CONFIG, port.gan.gen.state_dict(),
                        {"vocab_size": len(port.vocab), **ENC},
                        port.gan.cond_encoder.state_dict())
        loaded = GeneratorService.from_checkpoint(path, vocab_path=vocab_path,
                                                  batch_size=BATCH,
                                                  max_caption_len=MAX_LEN, device="cpu")
        np.testing.assert_array_equal(loaded.generate(sentences=SENTENCES, seed=2),
                                      port.generate(sentences=SENTENCES, seed=2))

    def test_cli_bench(self, monkeypatch, capsys):
        """The CLI's --bench path, with the flagship swapped for the small model."""
        import json
        from functools import partial
        from txt2vid_tpu_torch import serve
        monkeypatch.setattr(serve.tganv2_cond, "MultiScaleGen",
                            partial(tganv2.MultiScaleGen, **GEN_CONFIG))
        monkeypatch.setattr(serve, "Seq2Seq", partial(Seq2Seq, **ENC))
        serve.cli(["--bench", "5", "--batch_size", "4", "--device", "cpu"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["metric"] == "serve_videos_per_sec" and line["value"] > 0
        assert line["shape"] == [4, 32, 32, 3] and line["cond"] is True


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
        assert len(names) >= 37
        # the training slice's modules, the port's bench included, and the
        # training CLI's: trainer, EMA, checkpoints and their codec, config,
        # setup, data
        assert {f"txt2vid_tpu_torch.{m}" for m in (
            "bench", "gan.train_step", "gan.losses", "gan.cond_gan", "models.resnet3d",
            "ops.subsample", "utils.misc", "gan.trainer", "gan.ema", "train.gan",
            "train.setup", "config", "utils.checkpoint", "utils.msgpack", "utils.writer",
            "utils.logging", "utils.metrics", "utils.stopwatch", "data.synthetic",
            "data.__main__")} <= names
