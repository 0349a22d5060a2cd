"""The port's video files and sampling CLIs (txt2vid_tpu_torch/utils/video.py,
sample.py, serve --format) against the JAX package's on the CPU, tiny specs,
from a checkpoint the JAX package wrote, with JAX's z.

Tolerances: a luma GIF decodes to its frames bit for bit, and to the JAX
package's PIL-written GIF of the same frames; an RGB GIF within
video.RGB_MAX_ERROR per channel of its frames; the sampled float videos
within 1e-4 of JAX's (Pallas in interpret mode), so their uint8 frames and
files within 1 level.
"""

import io
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image, ImageSequence

from test_torch_models import pallas_interpret, random_variables
from txt2vid_tpu import sample as jax_sample
from txt2vid_tpu import serve as jax_serve
from txt2vid_tpu.config import create_object as jax_create_object
from txt2vid_tpu.data import Vocab as JaxVocab
from txt2vid_tpu.gan import ema as jax_ema
from txt2vid_tpu.gan import trainer as jax_trainer
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import init_state_abstract as jax_init_state_abstract
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu.utils import video as jax_video
from txt2vid_tpu_torch import sample as port_sample
from txt2vid_tpu_torch import serve
from txt2vid_tpu_torch.gan import trainer
from txt2vid_tpu_torch.utils import video

BATCH, MAX_LEN = 4, 10
ENC = dict(embed_size=8, hidden_size=16, num_layers=2)
# 1-channel specs, so the GIFs hold luma and decode exactly
SPEC_G = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
          "args": {"latent_size": 16, "width": 32, "height": 32, "num_channels": 1,
                   "fm_channels": 32, "additional_blocks": [32, 16], "num_frames": 4,
                   "use_pallas": True}}
SPEC_D = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
          "args": {"discrim_down_blocks": [1, 1, 1], "num_channels": 1, "use_pallas": True}}
SPEC_S = {"class": "txt2vid_tpu.models.txt.Seq2Seq", "args": ENC}
FRAME_SIZES = (8, 16, 32)
WORDS = ["digit", "is", "left", "and", "right", "top", "bottom"] + [str(i) for i in range(10)]
SENTENCES = ["digit 3 is left and right.", "digit 7 is top and bottom.",
             "digit 1 is right and left."]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_jax_run(root, seed=7):
    """A JAX init_state checkpoint of the tiny specs with random variables
    (G, D and the encoder; the init's zero gammas and unit statistics would
    render a constant video) and an `.ema` sibling; returns a dict of the
    paths, the JAX gan and state and the EMA params."""
    vocab = JaxVocab()
    for w in WORDS:
        vocab.add_word(w)
    vocab_path = root / "vocab.pickle"
    with open(vocab_path, "wb") as f:
        pickle.dump(vocab, f)
    txt = jax_create_object(SPEC_S, vocab_size=len(vocab))
    gan = JaxCondGan(gen=jax_create_object(SPEC_G, cond_dim=16),
                     discrims=[jax_create_object(SPEC_D, cond_dim=16)], cond_encoder=txt)
    rng = np.random.default_rng(seed)
    batch = {"video": jnp.asarray(rng.uniform(-1, 1, (BATCH, 4, 32, 32, 1)), jnp.float32),
             "captions": jnp.ones((BATCH, MAX_LEN), jnp.int32),
             "lengths": jnp.full((BATCH,), MAX_LEN, jnp.int32)}
    opt = optax.adam(1e-4)
    with pallas_interpret():
        state = jax_init_state_abstract(gan, jax.random.key(seed), batch, opt, opt,
                                        JaxTrainConfig(frame_sizes=FRAME_SIZES, latent_size=16))
    state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), state)

    def rand(tree):
        return jax.tree_util.tree_map(jnp.asarray, random_variables(tree, rng))
    state = state.replace(g_vars=rand(state.g_vars),
                          d_vars=tuple(rand(d) for d in state.d_vars),
                          txt_vars=rand(state.txt_vars))
    path = str(root / "iter_5_lossG_1.0000_lossD_1.0000")
    jax_checkpoint.save_state(state, path)
    ema = rand(state.g_vars["params"])
    jax_ema.save_ema(ema, path)
    return {"weights": path, "vocab": str(vocab_path), "gan": gan, "state": state,
            "ema": ema}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return write_jax_run(tmp_path_factory.mktemp("jax_run"))


def spec_argv(run, *extra):
    return ["--weights", run["weights"], "--G", json.dumps(SPEC_G), "--D", json.dumps(SPEC_D),
            "--sent", json.dumps(SPEC_S), "--vocab", run["vocab"],
            "--frame_sizes", *map(str, FRAME_SIZES), "--num_frames", "4",
            "--num_channels", "1", *extra]


def feed_z(monkeypatch, zs):
    """The port's sampling draws the given z, one array per sample() call."""
    it = iter(zs)
    monkeypatch.setattr(trainer, "draw_z", lambda b, n, g: torch.tensor(np.array(next(it))))


def decode_gif(data):
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for f in ImageSequence.Iterator(im):
        durations.append(f.info.get("duration"))
        frames.append(np.asarray(f.convert("RGB")))
    return np.stack(frames), durations, im.info.get("loop")


@pytest.mark.parametrize("fps", [8, 30, 1000])
def test_luma_gif_matches_pils(fps, tmp_path):
    """A luma clip (one frame repeated, which PIL merges into a longer frame)
    against the JAX package's PIL-written GIF: frames, durations, loop."""
    rng = np.random.default_rng(fps)
    v = rng.integers(0, 256, (6, 37, 29, 1)).astype(np.uint8)
    v[3] = v[2]
    jax_video.save_video(v, str(tmp_path / "jax.gif"), fps=fps)
    video.save_video(v, str(tmp_path / "port.gif"), fps=fps)
    ref = decode_gif((tmp_path / "jax.gif").read_bytes())
    got = decode_gif((tmp_path / "port.gif").read_bytes())
    assert got[1] == ref[1] and got[2] == ref[2] == 0
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0][..., 0], v[[0, 1, 2, 4, 5], ..., 0])
    smooth = np.linspace(-1, 1, 16 * 64 * 64).reshape(16, 64, 64, 1).astype(np.float32)
    frames, _, _ = decode_gif(video.gif_bytes(smooth))
    np.testing.assert_array_equal(frames[..., 0], video.to_uint8_frames(smooth)[..., 0])


def test_rgb_gif_within_the_palette_bound(tmp_path):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 256, (4, 20, 30, 3)).astype(np.uint8)
    frames, durations, loop = decode_gif(video.gif_bytes(v, fps=8))
    err = np.abs(frames.astype(int) - v.astype(int))
    assert err.max() <= video.RGB_MAX_ERROR == 25 and durations == [120] * 4 and loop == 0
    jax_video.save_video(v, str(tmp_path / "jax.gif"), fps=8)
    ref = decode_gif((tmp_path / "jax.gif").read_bytes())
    assert ref[0].shape == frames.shape and ref[1] == durations
    gray = np.repeat(v[..., :1], 3, axis=-1)
    np.testing.assert_array_equal(decode_gif(video.gif_bytes(gray))[0], gray)


@pytest.mark.parametrize("ext", [".avi", ".mp4", ".webm"])
def test_cv2_formats_raise_without_cv2(ext, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"\.gif"):
        video.save_video(np.zeros((2, 8, 8, 1), np.uint8), str(tmp_path / f"x{ext}"))
    with pytest.raises(ValueError, match="unsupported"):
        video.save_video(np.zeros((2, 8, 8, 1), np.uint8), str(tmp_path / "x.mkv"))


def jax_fakes(run, n, key, cond, ema=False):
    gan, state = run["gan"], run["state"]
    g_vars = jax_ema.with_ema_params(state.g_vars, run["ema"]) if ema else None
    with pallas_interpret():
        return np.asarray(jax_trainer.sample(gan, state, n, key, cond=cond, g_vars=g_vars)[-1])


@pytest.mark.parametrize("fmt,ema", [("png", False), ("gif", True)], ids=["png-live", "gif-ema"])
def test_sample_cli_matches_jax(jax_run, tmp_path, monkeypatch, fmt, ema):
    """`python -m txt2vid_tpu_torch.sample` on the JAX-written checkpoint (and
    its .ema) against JAX's sample CLI, z = normal(key(seed)) fed to both:
    the videos and the files they write."""
    run, seed = jax_run, 3
    extra = ["--sentences", *SENTENCES, "--seed", str(seed), "--format", fmt,
             *(["--ema"] if ema else [])]
    with pallas_interpret():
        jax_sample.cli(spec_argv(run, "--out_samples", str(tmp_path / "jax"), *extra))
    vocab, gan, state = jax_sample.load_pickle(run["vocab"]), run["gan"], run["state"]
    from txt2vid_tpu.data import encode_caption
    caps = [encode_caption(vocab, s) for s in SENTENCES]
    toks = np.zeros((3, max(map(len, caps))), np.int32)
    for i, c in enumerate(caps):
        toks[i, :len(c)] = c
    cond = gan.encode(state.txt_vars, jnp.asarray(toks),
                      jnp.asarray([len(c) for c in caps], jnp.int32))
    key = jax.random.key(seed)
    ref = jax_fakes(run, 3, key, cond, ema)
    feed_z(monkeypatch, [jax.random.normal(key, (3, 16))])
    got = port_sample.cli(spec_argv(run, "--out_samples", str(tmp_path / "port"),
                                    "--device", "cpu", *extra))
    assert got.shape == ref.shape == (3, 4, 32, 32, 1)
    assert float(np.abs(got - ref).max()) <= 1e-4 * max(1.0, float(np.abs(ref).max()))
    assert ref.std() > 0.05
    if fmt == "png":
        names = ["sample_32x32.png"]

        def read(p):
            return np.asarray(Image.open(p))
    else:
        names = [f"sample_32x32_{i}.gif" for i in range(3)]

        def read(p):
            return decode_gif(p.read_bytes())[0]
    for name in names:
        a, b = read(tmp_path / "jax" / name), read(tmp_path / "port" / name)
        assert a.shape == b.shape and int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_serve_gif_matches_jax_serve(jax_run, tmp_path, monkeypatch):
    """`serve --format gif` on the JAX-written checkpoint against JAX's serve
    CLI, with each chunk's JAX z: the same GIFs within one level."""
    run, seed = jax_run, 2
    extra = ["--sentences", *SENTENCES, "--seed", str(seed), "--format", "gif",
             "--batch_size", "2", "--max_caption_len", str(MAX_LEN)]
    with pallas_interpret():
        jax_serve.cli(spec_argv(run, "--out_samples", str(tmp_path / "jax"), *extra))
    monkeypatch.setattr(serve.GeneratorService, "_draw_z", lambda self, s, i: jax.random.normal(
        jax.random.fold_in(jax.random.key(s), i), (self.batch_size, 16)))
    out = serve.cli(spec_argv(run, "--out_samples", str(tmp_path / "port"), "--device", "cpu",
                              *extra))
    assert out.shape == (3, 4, 32, 32, 1)
    for i in range(3):
        a, da, la = decode_gif((tmp_path / "jax" / f"serve_{i}.gif").read_bytes())
        b, db, lb = decode_gif((tmp_path / "port" / f"serve_{i}.gif").read_bytes())
        assert da == db and la == lb == 0 and a.shape == b.shape
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
        np.testing.assert_array_equal(b[..., 0], out[i][..., 0])


def test_sample_flags_that_raise(jax_run):
    # --M on a checkpoint trained without a sample mapping: no m_vars to restore
    with pytest.raises(ValueError, match="m_vars"):
        port_sample.cli(spec_argv(jax_run, "--device", "cpu",
                                  "--M", "txt2vid_tpu.models.tcwyt.FrameMap"))
