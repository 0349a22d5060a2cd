"""The port's evaluation (txt2vid_tpu_torch/eval/: metrics, classifier,
alignment, run) against the JAX package's txt2vid_tpu/eval/ on the CPU, tiny
specs, the same clips and, where videos are sampled, JAX's z.

Tolerances: frechet_distance and fid_from_features equal exactly (the same
float64 numpy); RandomConvFeatures with JAX's params, the antialiased resize
and the frozen classifier's features 1e-5 of their scale (float32, summation
order); the classifier's predictions, centroid tracks, motion and digit
classes, the ceiling and the alignment accuracies equal; FIDs of features
that agree to 1e-5 within 1e-4 relative (plus 1e-6 absolute), cond_spread
1e-5 relative.
"""

import argparse
import gzip
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_models import pallas_interpret
from test_torch_sample import SPEC_D, SPEC_G, SPEC_S, feed_z, jax_run, spec_argv  # noqa: F401
from txt2vid_tpu.data import synthetic as jax_synthetic
from txt2vid_tpu.eval import alignment as jax_alignment
from txt2vid_tpu.eval import classifier as jax_classifier
from txt2vid_tpu.eval import metrics as jax_metrics
from txt2vid_tpu.eval import run as jax_run_mod
from txt2vid_tpu_torch.data import load_pickle
from txt2vid_tpu_torch.data import packed as port_packed
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.eval import alignment, classifier, metrics
from txt2vid_tpu_torch.eval import run as port_run
from txt2vid_tpu_torch.gan.cond_gan import load_checkpoint_gan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scaled_err(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - np.asarray(got, np.float64)).max()) / max(
        1.0, float(np.abs(ref).max()))


def close_fid(ref, got):
    return abs(ref - got) <= 1e-4 * abs(ref) + 1e-6


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """16 synthetic 16x64x64x1 clips the port wrote (the JAX generator's, byte
    for byte), with their captions."""
    d = tmp_path_factory.mktemp("clips")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=16, frame_size=(64, 64),
                      num_frames=16, seed=4, num_channels=1)
    return d


def test_frechet_distance_is_jaxs_exactly():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((40, 6)), rng.standard_normal((40, 6)) * 1.3 + 0.2
    for args in ((a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)),
                 (a.mean(0), np.cov(a, rowvar=False), a.mean(0), np.cov(a, rowvar=False))):
        assert metrics.frechet_distance(*args) == jax_metrics.frechet_distance(*args)
    assert metrics.fid_from_features(a, b) == jax_metrics.fid_from_features(a, b) > 0
    assert metrics.fid_from_features(a, a) == jax_metrics.fid_from_features(a, a) <= 1e-6


@pytest.mark.parametrize("shape", [(3, 4, 16, 16, 3), (2, 3, 9, 13, 1), (2, 5, 10, 7, 2)])
def test_random_conv_features_with_jax_params(shape):
    """SAME padding at even and odd sizes, where a symmetric padding of 1
    samples windows a pixel off."""
    v = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    ref, params = jax_metrics.extract_features(v, batch_size=2)
    model = metrics.RandomConvFeatures(shape[-1]).load_flax(params)
    got, _ = metrics.extract_features(v, model=model, batch_size=2, device="cpu")
    assert got.shape == ref.shape == (shape[0], 256)
    assert scaled_err(ref, got) <= 1e-5
    with torch.no_grad():
        conv = torch.nn.Conv3d(shape[-1], 32, 3, stride=(1, 2, 2), padding=1, bias=False)
        conv.weight.copy_(model.convs[0].weight)
        x = torch.from_numpy(v).permute(0, 4, 1, 2, 3)
        same, sym = model.convs[0](x), conv(x)
    assert same.shape == sym.shape
    assert (float((same - sym).abs().max()) > 1e-2) == (shape[2] % 2 == 0 or shape[3] % 2 == 0)


@pytest.mark.parametrize("src,dst", [((16, 64, 64), (16, 32, 32)), ((32, 128, 128), (16, 32, 32)),
                                     ((32, 32, 32), (16, 32, 32)), ((8, 20, 20), (16, 32, 32))],
                         ids=["64-px", "cond-128", "frames", "upsample"])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(2).uniform(-1, 1, (2, *src, 1)).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, *dst, 1), "linear"))
    got = classifier.resize_linear(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape and float(np.abs(ref - got).max()) <= 1e-5
    if src[1] > dst[1]:
        # interpolate without antialiasing is a different resampling
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x)[..., 0][:, None], size=dst, mode="trilinear")[:, 0, ..., None]
        assert float(np.abs(ref - plain.numpy()).max()) > 1e-2


def test_frozen_weights_are_the_jax_files():
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (jax_classifier.FROZEN_PATH, classifier.FROZEN_PATH)]
    assert digest[0] == digest[1] and classifier.FROZEN_PATH.stat().st_size > 0
    assert "txt2vid_tpu_torch/eval/weights" in str(classifier.FROZEN_PATH)


@pytest.mark.parametrize("shape", [(4, 16, 64, 64, 3), (3, 32, 128, 128, 1)],
                         ids=["64-px-rgb", "cond-128"])
def test_frozen_classifier_matches_jax(shape):
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, shape).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    params = jax_classifier.load_frozen()
    model = classifier.load_frozen(device="cpu")
    ref = jax_classifier.classifier_features(real, params, batch_size=2)
    got = classifier.classifier_features(real, model, batch_size=2)
    assert got.shape == ref.shape == (shape[0], 128) and scaled_err(ref, got) <= 1e-5
    for a, b in zip(jax_classifier.classify_videos(fake, params, batch_size=2),
                    classifier.classify_videos(fake, model, batch_size=2)):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    ref_fid = jax_classifier.classifier_fid(real, fake, params, batch_size=2)
    got_fid = classifier.classifier_fid(real, fake, model, batch_size=2)
    assert close_fid(ref_fid, got_fid) and got_fid > 0
    assert classifier.classifier_fid(real, real, model) <= 1e-6


def test_caption_labels():
    for cap in ("digit 3 is left and right.", "Digit 7 is bottom and top", "digit 1 is up.",
                "three is left and right."):
        assert classifier.caption_labels(cap) == jax_classifier.caption_labels(cap)


def classifier_tree(model, fn):
    """fn(parameter) for each of the port classifier's parameters, in the JAX
    classifier's tree and layout."""
    tree = {}
    for name, m in model.flax_modules().items():
        w = fn(m.weight).detach().clone()
        w = w.permute(2, 3, 4, 1, 0) if w.dim() == 5 else w.t() if w.dim() == 2 else w
        leaf = {"kernel" if m.weight.dim() > 1 else "scale": w.numpy()}
        if m.bias is not None:
            leaf["bias"] = fn(m.bias).detach().clone().numpy()
        tree[name] = leaf
    return tree


def jax_classifier_step64(start, lr, t):
    """The JAX classifier's training step in float64 from `start` (the JAX
    run's params, Adam moments and batch before step t): loss, the moments
    after it and the params, by optax.adam's rule."""
    model = jax_classifier._build_model()
    video, digit, motion = start["batch"]

    def loss_fn(p, v):
        _, dl, ml = model.apply(p, v)
        return (optax.softmax_cross_entropy_with_integer_labels(dl, digit).mean()
                + optax.softmax_cross_entropy_with_integer_labels(ml, motion).mean())

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        {"params": start["params"]})
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(video, jnp.float64))
        grads = jax.tree_util.tree_map(np.asarray, grads["params"])
    return float(loss), adam_update(start, grads, lr, t)


def adam_update(start, grads, lr, t):
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8) at its step t + 1 from
    start's params and moments: {"mu", "rms" (the second moment's root),
    "params"}, each in the classifier's tree. optax takes the bias
    corrections' powers of the decays in float32 (1 - 0.999 is 1.3e-5 off
    there, where torch's Adam is exact: a relative 6.4e-6 of each update)."""
    tree = jax.tree_util.tree_map
    mu = tree(lambda m, g: 0.9 * m + 0.1 * g, start["mu"], grads)
    nu = tree(lambda v, g: 0.999 * v + 0.001 * g * g, start["nu"], grads)
    c1, c2 = (1 - np.float32(b) ** (t + 1) for b in (0.9, 0.999))
    params = tree(lambda p, m, v: p - lr * (m / c1) / (np.sqrt(v / c2) + 1e-8),
                  start["params"], mu, nu)
    return {"mu": mu, "rms": tree(np.sqrt, nu), "params": params}


def test_classifier_training_cli(clips, tmp_path, monkeypatch, capsys):
    """`python -m txt2vid_tpu_torch.eval.classifier` against the JAX package's
    training CLI, 3 steps of batch 4 on the same packed clips, each port step
    from the JAX run's state before it. The batch (both draw it with
    default_rng(seed).choice) and labels equal JAX's; the loss within 1e-5 of
    JAX's; the Adam moments (the second as its root) within 1e-4 of their
    scale of JAX's step in float64. On these clips (a constant background)
    the first conv's gradient sums GroupNorm's zero-mean output gradients
    over a nearly constant input: the port's float32 lies up to 5e-5 of the
    scale from float64, JAX's own up to 1.2e-3, so float64 is the reference.
    The params within 1e-5 of their scale of float64's where its first moment
    is at least 1e-4 of the leaf's largest (at least 75% of each leaf), and
    within 2 lr elsewhere: Adam moves each element by about lr, so where the
    gradient is within its rounding of 0 either sign is right. The float64
    step's Adam rule gives JAX's own params from JAX's own moments; the
    validation report equals JAX's; the JAX package reads the port's file."""
    port_packed.pack_directory(clips / "videos", tmp_path / "v.t2vc")
    flags = dict(data=str(tmp_path / "v.t2vc"), anno=str(clips / "sent.pickle"),
                 val_videos=str(clips / "videos"), val_anno=str(clips / "sent.pickle"),
                 val_n=8, steps=3, batch_size=4, lr=1e-3, seed=3)
    # JAX's jitted train_step(params, opt_state, video, digit, motion) ->
    # (params, opt_state, loss, acc_d, acc_m)
    ref, jit = [], jax.jit

    def state(params, opt_state):
        return {"params": params["params"], "mu": opt_state[0].mu["params"],
                "nu": opt_state[0].nu["params"]}

    def recording_jit(fn, *a, **kw):
        compiled = jit(fn, *a, **kw)

        def call(*args):
            out = compiled(*args)
            if len(out) == 5:
                ref.append(jax.tree_util.tree_map(np.asarray, {
                    "start": {**state(*args[:2]), "batch": args[2:]},
                    "end": state(*out[:2]), "loss": out[2]}))
            return out
        return call

    with monkeypatch.context() as m:
        m.setattr(jax, "jit", recording_jit)
        jax_classifier.main(argparse.Namespace(**flags, out=str(tmp_path / "jax.msgpack")))
    ref_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    got, step = [], classifier.train_step

    def recording_step(model, opt, video, lab):
        start = ref[len(got)]["start"]
        np.testing.assert_array_equal(video.numpy(), start["batch"][0])
        np.testing.assert_array_equal(lab.numpy().T, np.stack(start["batch"][1:]))
        model.load_flax({"params": start["params"]})
        if opt.state:
            for key, tree in (("exp_avg", start["mu"]), ("exp_avg_sq", start["nu"])):
                moments = classifier.VideoClassifier().load_flax({"params": tree})
                with torch.no_grad():
                    for p, q in zip(model.parameters(), moments.parameters()):
                        opt.state[p][key].copy_(q)
        out = step(model, opt, video, lab)
        got.append({"params": classifier_tree(model, lambda p: p),
                    "mu": classifier_tree(model, lambda p: opt.state[p]["exp_avg"]),
                    "rms": classifier_tree(model, lambda p: opt.state[p]["exp_avg_sq"].sqrt()),
                    "loss": float(out[0].detach())})
        return out

    monkeypatch.setattr(classifier, "train_step", recording_step)
    report = classifier.main(argparse.Namespace(
        **flags, out=str(tmp_path / "port.msgpack"), device="cpu"))
    assert report == ref_report and len(got) == len(ref) == 3

    def rel(a, b, where=Ellipsis):
        return float(np.abs(a - b)[where].max()) / float(np.abs(a).max())

    lr = flags["lr"]
    for t, (r, g) in enumerate(zip(ref, got)):
        loss64, want = jax_classifier_step64(r["start"], lr, t)
        assert abs(float(r["loss"]) - g["loss"]) <= 1e-5 * max(1.0, abs(float(r["loss"])))
        assert abs(loss64 - g["loss"]) <= 1e-5 * max(1.0, abs(loss64))
        own = adam_update(r["start"], jax.tree_util.tree_map(
            lambda m, m0: (m - 0.9 * m0) / 0.1, r["end"]["mu"], r["start"]["mu"]), lr, t)
        for mod, leaves in want["params"].items():
            for leaf, p64 in leaves.items():
                mu64 = want["mu"][mod][leaf]
                assert rel(mu64, g["mu"][mod][leaf]) <= 1e-4, (t, "mu", mod, leaf)
                assert rel(want["rms"][mod][leaf], g["rms"][mod][leaf]) <= 1e-4, (t, mod, leaf)
                firm = np.abs(mu64) >= 1e-4 * np.abs(mu64).max()
                err = np.abs(p64 - g["params"][mod][leaf])
                assert firm.mean() >= 0.75 and rel(p64, g["params"][mod][leaf], firm) <= 1e-5, (
                    t, "params", mod, leaf, firm.mean())
                assert err.max() <= 2 * lr, (t, "params", mod, leaf)
                assert rel(r["end"]["params"][mod][leaf], own["params"][mod][leaf]) <= 1e-6
    written = jax_classifier.load_frozen(str(tmp_path / "port.msgpack"))["params"]
    for mod, leaves in got[-1]["params"].items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(np.asarray(written[mod][leaf]),
                                          a.astype(np.float16).astype(np.float32))


def test_motion_and_digit_classes_match_jax(clips):
    sents = load_pickle(clips / "sent.pickle")
    np.testing.assert_array_equal(alignment._digit_templates(),
                                  jax_alignment._digit_templates())
    for vid in list(sents)[:6]:
        v = np.load(clips / "videos" / f"{vid}.npy")
        f = v.astype(np.float32) / 127.5 - 1.0
        for clip in (v, f):
            np.testing.assert_array_equal(alignment.centroid_track(clip),
                                          jax_alignment.centroid_track(clip))
            assert alignment.classify_motion(clip) == jax_alignment.classify_motion(clip)
            assert alignment.classify_digit(clip) == jax_alignment.classify_digit(clip)


def test_real_data_ceiling_matches_jax(clips):
    """Pure numpy on the same clips; on the port's clips (the JAX package's
    glyphs) the digit templates find every digit."""
    args = (clips / "videos", clips / "sent.pickle")
    got = alignment.real_data_ceiling(*args)
    assert got == jax_alignment.real_data_ceiling(str(args[0]), str(args[1]))
    assert got["n"] == 16 and got["real_accuracy_digit"] == 1.0


def write_mnist(root, per_class=3):
    rng = np.random.default_rng(5)
    labels = np.repeat(np.arange(10, dtype=np.uint8), per_class)
    images = rng.integers(0, 256, (len(labels), 28, 28)).astype(np.uint8)
    with gzip.open(root / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(np.array([2051, len(labels), 28, 28], ">u4").tobytes() + images.tobytes())
    with gzip.open(root / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(np.array([2049, len(labels)], ">u4").tobytes() + labels.tobytes())
    return root


def test_mnist_templates_and_clips_match_jax(tmp_path):
    mnist = write_mnist(tmp_path)
    np.testing.assert_array_equal(alignment._digit_templates(mnist_path=str(mnist)),
                                  jax_alignment._digit_templates(mnist_path=str(mnist)))
    kw = dict(num_examples=4, frame_size=(32, 32), num_frames=4, seed=2, mnist_path=str(mnist))
    assert (generate_examples(tmp_path / "p", tmp_path / "p.pickle", **kw)
            == jax_synthetic.generate_examples(tmp_path / "j", tmp_path / "j.pickle", **kw))
    for i in range(4):
        np.testing.assert_array_equal(np.load(tmp_path / "p" / f"{i}.npy"),
                                      np.load(tmp_path / "j" / f"{i}.npy"))


def jax_split_z(seed, sizes, latent=16):
    """The z of the JAX package's per-batch sampling: key, kz = split(key)."""
    key, out = jax.random.key(seed), []
    for b in sizes:
        key, kz = jax.random.split(key)
        out.append(jax.random.normal(kz, (b, latent)))
    return out


def test_alignment_report_matches_jax(jax_run, monkeypatch):  # noqa: F811
    """alignment_report from the JAX-written checkpoint, k = 3 per class
    in batches of 5, with JAX's z."""
    gan, state = jax_run["gan"], jax_run["state"]
    vocab = load_pickle(jax_run["vocab"])
    with pallas_interpret():
        ref = jax_alignment.alignment_report(gan, state, vocab, k_per_class=3, seed=1,
                                             batch_size=5)
    port_gan, _ = load_checkpoint_gan(jax_run["weights"], SPEC_G, [SPEC_D], sent=SPEC_S,
                                      vocab_path=jax_run["vocab"], frame_sizes=(8, 16, 32),
                                      num_frames=4, num_channels=1)
    feed_z(monkeypatch, jax_split_z(1, [5, 5, 2]))
    got = alignment.alignment_report(port_gan, vocab, k_per_class=3, seed=1, batch_size=5)
    spread = got.pop("cond_spread")
    assert abs(spread - ref.pop("cond_spread")) <= 1e-5 * spread and spread > 0.1
    assert got == ref and got["n"] == 12


def test_alignment_cli(jax_run, clips, tmp_path, capsys):  # noqa: F811
    """The CLI with --ema, --mnist and the real-data ceiling: a finite report
    whose digit templates are MNIST's."""
    mnist = write_mnist(tmp_path)
    args = alignment.build_parser().parse_args(spec_argv(
        jax_run, "--k_per_class", "2", "--batch_size", "4", "--seed", "5", "--ema",
        "--mnist", str(mnist), "--real_videos", str(clips / "videos"),
        "--real_sents", str(clips / "sent.pickle"), "--device", "cpu"))
    report = alignment.main(args)
    out = capsys.readouterr().out
    assert json.loads(out[out.rindex('{\n  "accuracy_4way"'):]) == report
    # the ceiling's count replaces the sample count, as in the JAX CLI
    assert report["n"] == 16 and report["real_accuracy_digit"] < 1.0
    assert all(np.isfinite(report[k]) for k in ("accuracy_4way", "cond_spread"))
    # --M on a checkpoint trained without a sample mapping: no m_vars to restore
    with pytest.raises(ValueError, match="m_vars"):
        alignment.main(alignment.build_parser().parse_args(spec_argv(
            jax_run, "--M", "txt2vid_tpu.models.tcwyt.FrameMap", "--device", "cpu")))


@pytest.mark.parametrize("packed", [False, True], ids=["npy-discrim-fid", "packed-no-discrim"])
def test_eval_run_matches_jax(jax_run, tmp_path, monkeypatch, packed):  # noqa: F811
    """eval.run's report from the JAX-written checkpoint on 32-px luma clips
    (a directory, or the packed dataset's spec with --no_discrim_fid as r9
    runs it), 2 batches of 4, with JAX's z and JAX's random-conv params."""
    d = tmp_path / "data"
    generate_examples(d / "videos", d / "sent.pickle", num_examples=10, frame_size=(32, 32),
                      num_frames=4, seed=3, num_channels=1)
    data = str(d / "videos")
    if packed:
        port_packed.pack_directory(d / "videos", d / "v.t2vc")
        data = json.dumps({"class": "txt2vid_tpu.data.packed.packed_dataset",
                           "args": {"data": str(d / "v.t2vc")}})
    ns = dict(weights=jax_run["weights"], G=json.dumps(SPEC_G), D=[json.dumps(SPEC_D)],
              sent=json.dumps(SPEC_S), M=None, vocab=jax_run["vocab"], dont_use_sent=False,
              data=data, anno=str(d / "sent.pickle"), frame_sizes=[8, 16, 32], num_frames=4,
              num_channels=1, num=9, batch_size=4, seed=6, no_discrim_fid=packed)
    with pallas_interpret():
        ref = jax_run_mod.main(argparse.Namespace(**ns))
    real = np.stack([np.load(d / "videos" / f"{i}.npy") for i in range(10)])
    _, conv_params = jax_metrics.extract_features(real[:1].astype(np.float32) / 127.5 - 1)
    port_conv = metrics.RandomConvFeatures

    def jax_params_conv(c, *a):
        return port_conv(c).load_flax(conv_params)

    monkeypatch.setattr(metrics, "RandomConvFeatures", jax_params_conv)
    feed_z(monkeypatch, jax_split_z(6, [4, 4]))
    got = port_run.main(argparse.Namespace(**ns, device="cpu"))
    assert sorted(got) == sorted(ref)
    assert ("fid_discrim" in got) != packed and "fid_cls" in got
    for k in ref:
        if k.startswith("fid"):
            assert close_fid(ref[k], got[k]), (k, ref[k], got[k])
        else:
            assert abs(ref[k] - got[k]) <= 1e-5, (k, ref[k], got[k])


def test_the_slice_and_chip_smoke_import_no_jax():
    """The sampling, evaluation and pretraining modules and chip_smoke.py
    import neither JAX nor the JAX package (nor PIL or cv2, which the card's
    machine lacks); the frozen weights are the port's own copy."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import importlib, sys\n"
        "for n in ('txt2vid_tpu_torch.sample', 'txt2vid_tpu_torch.utils.video',\n"
        "          'txt2vid_tpu_torch.eval.metrics', 'txt2vid_tpu_torch.eval.classifier',\n"
        "          'txt2vid_tpu_torch.eval.alignment', 'txt2vid_tpu_torch.eval.run',\n"
        "          'txt2vid_tpu_torch.train.txt', 'chip_smoke'):\n"
        "    importlib.import_module(n)\n"
        "from txt2vid_tpu_torch.eval import classifier\n"
        "assert classifier.load_frozen(device='cpu') is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'PIL', 'cv2', 'txt2vid_tpu')]\n"
        "assert not bad, bad\n"
        "print(classifier.FROZEN_PATH)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(repo / "txt2vid_tpu_torch" / "eval" / "weights"
                                     / "video_cls.msgpack")
