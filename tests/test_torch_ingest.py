"""The port's data ingest (txt2vid_tpu_torch/data/cache.py, mrvdc.py,
mrvdc_yt.py, reddit.py, split.py, benchmark.py), its frame-directory clips
(data.load_video_frames) and ops.subsample_rect against the JAX package's, on
the CPU, on files the tests write: .avi and .mp4 videos (cv2.VideoWriter),
directories of .jpg and .png frames (PIL), an MSR.csv and a reddit JSON.

Held exactly: the decoded arrays, the cached .npy files byte for byte (the
functions and the CLIs), the captions pickles byte for byte, which files
the split sends where, the frame-directory clips in float32 and uint8, and
subsample_rect's crop with JAX's drawn offsets replayed. Then the training
CLI runs steps on a frame-directory dataset, which the port refused before.
"""

import json
import pickle
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

from txt2vid_tpu.data import load_video_frames as jax_load_video_frames  # noqa: E402
from txt2vid_tpu.data import cache as jax_cache  # noqa: E402
from txt2vid_tpu.data import mrvdc as jax_mrvdc  # noqa: E402
from txt2vid_tpu.data import reddit as jax_reddit  # noqa: E402
from txt2vid_tpu.data import split as jax_split  # noqa: E402
from txt2vid_tpu.ops import subsample as jax_subsample  # noqa: E402
from txt2vid_tpu_torch.data import build_vocab, load_video_frames, my_dataset  # noqa: E402
from txt2vid_tpu_torch.data import benchmark, cache, mrvdc, mrvdc_yt, reddit, split  # noqa: E402
from txt2vid_tpu_torch.ops import subsample_rect  # noqa: E402
from txt2vid_tpu_torch.train import gan as train_gan  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models on one intra-op thread: beside other test processes,
    torch's thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_video(path, num_frames=40, size=48, codec="XVID", seed=0):
    """A clip whose frame t is t * 5 plus a seeded gradient per channel, so
    that frames differ in time and channels differ in colour."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 60, size)[None, :, None] * rng.uniform(0.5, 1.5, 3)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), 8.0, (size, size))
    assert w.isOpened()
    for t in range(num_frames):
        w.write(np.clip(t * 5 + ramp + np.zeros((size, 1, 1)), 0, 255).astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Four .avi clips of 40 frames, an .mp4, a short clip (10 frames, fewer
    than the cache keeps), an upper-case suffix, a file that does not decode
    and a file the cache skips."""
    root = tmp_path_factory.mktemp("videos")
    for i in range(4):
        write_video(root / f"vid{i}.avi", seed=i)
    write_video(root / "vid4.mp4", codec="mp4v", seed=4)
    write_video(root / "short.avi", num_frames=10, seed=5)
    write_video(root / "UPPER.AVI", seed=6)
    (root / "broken.avi").write_bytes(b"not a video")
    (root / "notes.txt").write_text("skipped")
    return root


def test_decode_video_equals_jax(videos):
    for f in sorted(videos.iterdir()):
        for size in (None, 32):
            ref, got = jax_cache.decode_video(f, size), cache.decode_video(f, size)
            if f.name in ("broken.avi", "notes.txt"):
                assert ref is None and got is None
                continue
            assert got.dtype == np.uint8 and got.shape[1:] == ((48, 48, 3) if size is None
                                                                else (32, 32, 3))
            np.testing.assert_array_equal(got, ref, err_msg=f"{f.name} at {size}")
    # BGR -> RGB: the clip's channels were scaled differently
    frames = cache.decode_video(videos / "vid0.avi")
    assert frames[20].mean(axis=(0, 1)).std() > 1.0


def test_decode_video_without_cv2(videos, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert cache.decode_video(videos / "vid0.avi") is None
    assert cache.cache_one((str(videos / "vid0.avi"), str(videos), 32, 16)) == ("vid0", False)
    assert mrvdc.probe_num_frames(videos / "vid0.avi") is None


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def test_build_cache_matches_jax_byte_for_byte(videos, tmp_path):
    """build_cache (2 spawned workers) and its CLI write JAX's .npy files: 16
    evenly spaced frames of the long clips, all 10 of the short one, no file
    for what does not decode."""
    ref = jax_cache.build_cache(videos, tmp_path / "jax", size=32, num_frames=16, workers=2)
    got = cache.build_cache(videos, tmp_path / "port", size=32, num_frames=16, workers=2)
    assert got == ref and dict(got) == {**{f"vid{i}": True for i in range(5)}, "short": True,
                                         "UPPER": True, "broken": False}
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 7
    assert np.load(tmp_path / "port" / "vid1.npy").shape == (16, 32, 32, 3)
    assert np.load(tmp_path / "port" / "short.npy").shape == (10, 32, 32, 3)
    res = subprocess.run([sys.executable, "-m", "txt2vid_tpu_torch.data.cache", "--videos",
                          str(videos), "--out", str(tmp_path / "cli"), "--size", "32",
                          "--num_frames", "16", "--workers", "2"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "cached 7/8 videos" in res.stdout
    assert _files(tmp_path / "cli") == files
    # an existing .npy is kept, not decoded again
    marker = tmp_path / "port" / "vid2.npy"
    marker.write_bytes(b"kept")
    assert cache.cache_one((str(videos / "vid2.avi"), str(tmp_path / "port"), 32, 16)) == \
        ("vid2", True)
    assert marker.read_bytes() == b"kept"


def _run_cli(module, argv, monkeypatch):
    """`python -m module argv` in this process (the imported module left out
    of sys.modules while its __main__ copy runs)."""
    monkeypatch.setattr(sys, "argv", [module, *argv])
    monkeypatch.delitem(sys.modules, module, raising=False)
    runpy.run_module(module, run_name="__main__")


def test_mrvdc_pickles_equal_jax(tmp_path, monkeypatch, capsys):
    """English descriptions of at most 60 characters, keyed
    <VideoID>_<Start>_<End>; with --videos, a missing clip is counted and a
    clip under 32 frames (cv2's count) dropped. read_csv and the CLI."""
    vdir = tmp_path / "clips"
    vdir.mkdir()
    write_video(vdir / "vidA_0_10.avi", num_frames=40)
    write_video(vdir / "vidB_5_9.avi", num_frames=8)
    write_video(vdir / "vidD_3_7.mp4", num_frames=33, codec="mp4v")
    rows = [("vidA", 0, 10, "English", "a person cooks pasta."),
            ("vidA", 0, 10, "English", "someone is cooking."),
            ("vidA", 0, 10, "Spanish", "una persona cocina."),
            ("vidA", 0, 10, "English", "x" * 61),
            ("vidA", 0, 10, "English", "y" * 60),
            ("vidB", 5, 9, "English", "too few frames."),
            ("vidC", 1, 2, "English", "a missing clip."),
            ("vidC", 1, 2, "English", "another row of it."),
            ("vidD", 3, 7, "English", "  padded with spaces.  ")]
    csv = tmp_path / "MSR.csv"
    with open(csv, "w") as f:
        f.write("VideoID,Start,End,Language,Description\n")
        for vid, s, e, lang, desc in rows:
            f.write(f'{vid},{s},{e},{lang},"{desc}"\n')
    for videos in (vdir, None):
        ref, got = jax_mrvdc.read_csv(csv, videos), mrvdc.read_csv(csv, videos)
        assert got == ref and list(got) == list(ref)
    assert mrvdc.read_csv(csv, vdir) == {
        "vidA_0_10": ["a person cooks pasta.", "someone is cooking.", "y" * 60],
        "vidD_3_7": ["padded with spaces."]}
    capsys.readouterr()
    for name, mod in (("jax", "txt2vid_tpu.data.mrvdc"), ("port", "txt2vid_tpu_torch.data.mrvdc")):
        _run_cli(mod, ["--csv", str(csv), "--videos", str(vdir), "--out",
                       str(tmp_path / f"{name}.pickle")], monkeypatch)
        assert capsys.readouterr().out == "missing 2 clips\n2 clips\n"
    assert (tmp_path / "jax.pickle").read_bytes() == (tmp_path / "port.pickle").read_bytes()


def test_mrvdc_yt_raises_without_the_client(monkeypatch):
    monkeypatch.setitem(sys.modules, "googleapiclient", None)
    monkeypatch.setitem(sys.modules, "googleapiclient.discovery", None)
    with pytest.raises(RuntimeError, match="google-api-python-client"):
        mrvdc_yt.lookup_categories(["abc"], api_key="k")


def test_reddit_pickles_equal_jax(tmp_path, monkeypatch):
    entries = [{"url": "https://v.redd.it/abc?x=1&y=2", "title": "a cat jumps"},
               {"url": "https://v.redd.it/abc?x=1&y=2", "title": "the same video"},
               {"url": "https://i.imgur.com/def.gifv", "title": "a dog runs"},
               {"url": "http://youtu.be/a%20b=c", "title": "percent and equals"}]
    jp = tmp_path / "scraped.json"
    jp.write_text(json.dumps(entries))
    for e in entries:
        assert reddit.url_to_key(e["url"]) == jax_reddit.url_to_key(e["url"])
    assert reddit.url_to_key("https://v.redd.it/abc?x=1&y=2") == "https___v_redd_it_abc_x_1_y_2"
    for name, mod in (("jax", "txt2vid_tpu.data.reddit"), ("port", "txt2vid_tpu_torch.data.reddit")):
        _run_cli(mod, ["--json", str(jp), "--out", str(tmp_path / f"{name}.pickle")], monkeypatch)
    data = (tmp_path / "port.pickle").read_bytes()
    assert data == (tmp_path / "jax.pickle").read_bytes()
    assert pickle.loads(data) == reddit.convert(jp, tmp_path / "again.pickle")
    assert len(pickle.loads(data)) == 3


def test_split_sends_the_same_files_the_same_way(tmp_path, monkeypatch):
    """Seeded 80/20 over files and frame directories (copied whole); the CLI
    too."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(9):
        (src / f"v{i}.npy").write_bytes(bytes([i]))
    for i in range(3):
        (src / f"d{i}").mkdir()
        for t in range(2):
            (src / f"d{i}" / f"{t}.png").write_bytes(bytes([i, t]))

    def tree(d):
        return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*"))

    for seed in (0, 3):
        ref = jax_split.split(src, tmp_path / f"jt{seed}", tmp_path / f"jv{seed}", seed=seed)
        got = split.split(src, tmp_path / f"pt{seed}", tmp_path / f"pv{seed}", seed=seed)
        assert got == ref == (9, 3)
        for a, b in ((f"jt{seed}", f"pt{seed}"), (f"jv{seed}", f"pv{seed}")):
            assert tree(tmp_path / a) == tree(tmp_path / b)
            for f in tree(tmp_path / b):
                if (tmp_path / b / f).is_file():
                    assert (tmp_path / b / f).read_bytes() == (src / f).read_bytes()
    assert tree(tmp_path / "pt0") != tree(tmp_path / "pt3")
    _run_cli("txt2vid_tpu_torch.data.split", ["--src", str(src), "--train", str(tmp_path / "ct"),
                                              "--val", str(tmp_path / "cv")], monkeypatch)
    assert tree(tmp_path / "ct") == tree(tmp_path / "pt0")


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """Frame directories: .jpg (RGB) numbered 1..12 (so 10 sorts after 9),
    .png greyscale (2-D frames), and one holding both for each n (.jpg
    first); 24x20 frames, larger than the 16-px crop."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    kinds = {"rgb_jpg": ("jpg", 3, range(1, 13)), "grey_png": ("png", 1, range(9)),
             "both": ("both", 3, range(8))}
    for name, (ext, c, ns) in kinds.items():
        d = root / name
        d.mkdir()
        for n in ns:
            px = rng.integers(0, 256, (24, 20, c) if c == 3 else (24, 20), dtype=np.uint8)
            if ext in ("jpg", "both"):
                Image.fromarray(px).save(d / f"{n}.jpg")
            if ext in ("png", "both"):
                Image.fromarray(255 - px).save(d / f"{n}.png")
    (root / "rgb_jpg" / "notes.txt").write_text("not a frame")
    return root


@pytest.mark.parametrize("normalize", [True, False], ids=["float32", "uint8"])
@pytest.mark.parametrize("name", ["rgb_jpg", "grey_png", "both"])
def test_frame_directory_equals_jax(frame_dirs, name, normalize):
    for frame_size, channels, random in ((None, 3, False), (16, 1, False), (16, 3, True)):
        kw = dict(num_frames=4, frame_size=frame_size, num_channels=channels,
                  random_frames=random, normalize=normalize)
        ref = jax_load_video_frames(frame_dirs / name, rng=np.random.default_rng(1), **kw)
        got = load_video_frames(frame_dirs / name, rng=np.random.default_rng(1), **kw)
        assert got.dtype == ref.dtype == (np.float32 if normalize else np.uint8)
        np.testing.assert_array_equal(got, ref)
    first = load_video_frames(frame_dirs / name, 1, normalize=False, num_channels=3)[0]
    want = np.asarray(Image.open(frame_dirs / name / ("1.jpg" if name == "rgb_jpg" else (
        "0.png" if name == "grey_png" else "0.jpg"))))
    np.testing.assert_array_equal(first, want if want.ndim == 3 else np.repeat(
        want[..., None], 3, axis=-1))


def _jax_offsets(key, x, w, h, depth=None):
    """The crop offsets subsample_rect draws from `key`."""
    r = jax.random
    if x.ndim == 4:
        kh, kw = r.split(key)
        return (int(r.randint(kh, (), 0, x.shape[1] - h + 1)),
                int(r.randint(kw, (), 0, x.shape[2] - w + 1)))
    kd, kh, kw = r.split(key, 3)
    d = depth if depth is not None else x.shape[1]
    return (int(r.randint(kd, (), 0, x.shape[1] - d + 1)),
            int(r.randint(kh, (), 0, x.shape[2] - h + 1)),
            int(r.randint(kw, (), 0, x.shape[3] - w + 1)))


@pytest.mark.parametrize("shape,w,h,depth", [((2, 12, 10, 3), 5, 7, None),
                                             ((2, 8, 12, 10, 3), 5, 7, 3),
                                             ((2, 8, 12, 10, 3), 10, 12, None)],
                         ids=["4d", "5d", "5d_full"])
def test_subsample_rect_equals_jax(shape, w, h, depth):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        ref = np.asarray(jax_subsample.subsample_rect(jax.numpy.asarray(x), key, w, h, depth))
        got = subsample_rect(torch.from_numpy(x), w, h, depth,
                             offsets=_jax_offsets(key, x, w, h, depth))
        np.testing.assert_array_equal(got.numpy(), ref)
    drawn = subsample_rect(torch.from_numpy(x), w, h, depth,
                           generator=torch.Generator().manual_seed(0))
    assert drawn.shape == ref.shape
    with pytest.raises(ValueError, match="offsets"):
        subsample_rect(torch.from_numpy(x), w, h, depth, offsets=(99,) * (x.ndim - 2))
    with pytest.raises(ValueError, match="larger"):
        subsample_rect(torch.from_numpy(x), 99, h, depth)


def test_benchmark_reads_every_item(frame_dirs, tmp_path, monkeypatch, capsys):
    dset = my_dataset(data=str(frame_dirs), anno={"rgb_jpg": ["a"], "both": ["b", "c"]},
                      num_frames=4)
    total, per_item = benchmark.benchmark(dset)
    assert len(dset) == 3 and total >= 0 and per_item == pytest.approx(total / 3)
    spec = json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(frame_dirs), "num_frames": 4}})
    anno = tmp_path / "anno.pickle"
    anno.write_bytes(pickle.dumps({"grey_png": ["d"], "both": ["e"]}))
    capsys.readouterr()
    _run_cli("txt2vid_tpu_torch.data.benchmark",
             ["--data", spec, "--anno", str(anno), "--num_items", "1"], monkeypatch)
    assert capsys.readouterr().out.startswith("1 items in ")


def test_ingest_modules_import_no_optional_dependency():
    """The ingest modules, the importer and ops import nothing of JAX and no
    cv2, PIL or pandas (which the card's machine lacks) when imported; the
    host tools (cache, mrvdc, mrvdc_yt, reddit, split, and benchmark with
    the dataset a spec builds) import no torch."""
    code = (
        "import importlib, sys\n"
        "for m in ('cv2', 'PIL', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "host = ('cache', 'mrvdc', 'mrvdc_yt', 'reddit', 'split', 'benchmark')\n"
        "for n in host:\n"
        "    importlib.import_module('txt2vid_tpu_torch.data.' + n)\n"
        "from txt2vid_tpu_torch.config import create_object\n"
        "create_object({'class': 'txt2vid_tpu.data.my_dataset', 'args': {'data': '.'}}, anno={})\n"
        "assert 'torch' not in sys.modules\n"
        "for n in ('txt2vid_tpu_torch.compat',\n"
        "          'txt2vid_tpu_torch.compat.torch_import', 'txt2vid_tpu_torch.ops'):\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'txt2vid_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


G = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
     "args": {"latent_size": 16, "width": 16, "height": 16, "fm_channels": 16,
              "additional_blocks": [8], "num_frames": 4, "use_pallas": False}}
D = {"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
     "args": {"discrim_down_blocks": [1, 1], "num_channels": 3}}
S = {"class": "txt2vid.models.txt.basic.Seq2Seq",
     "args": {"embed_size": 16, "hidden_size": 16, "num_layers": 1}}


def test_train_cli_on_frame_directories(tmp_path):
    """2 steps of the training CLI (test_torch_cli's tiny specs) on a
    my_dataset of PNG frame directories: the layout that raised before."""
    rng = np.random.default_rng(4)
    clips, caps = tmp_path / "clips", {}
    for i in range(8):
        d = clips / f"clip{i}"
        d.mkdir(parents=True)
        for t in range(6):
            Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(d / f"{t}.png")
        caps[f"clip{i}"] = [f"digit {i} is left and right."]
    (tmp_path / "sent.pickle").write_bytes(pickle.dumps(caps))
    (tmp_path / "vocab.pickle").write_bytes(
        pickle.dumps(build_vocab([c for v in caps.values() for c in v])))
    spec = {"class": "txt2vid_tpu.data.my_dataset", "args": {"data": str(clips), "num_frames": 4}}
    out = tmp_path / "out"
    train_gan.cli(["--device", "cpu", "--G", json.dumps(G), "--D", json.dumps(D),
                   "--sent", json.dumps(S), "--data", json.dumps(spec),
                   "--anno", str(tmp_path / "sent.pickle"), "--vocab", str(tmp_path / "vocab.pickle"),
                   "--frame_sizes", "8", "16", "--subsample_input", "--num_channels", "3",
                   "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--batch_size", "4",
                   "--epochs", "1", "--seed", "2", "--workers", "1", "--save_model_period", "2",
                   "--out", str(out), "--out_samples", str(out / "samples")])
    saved = [p.name for p in out.iterdir() if p.name.startswith("iter_2_")]
    assert len(saved) == 1
    assert all(np.isfinite(float(x)) for x in saved[0].split("_")[3::2])
