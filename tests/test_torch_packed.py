"""The packed frame cache (txt2vid_tpu_torch/data/packed.py, native/
framecache.cpp) and BatchLoader against the JAX package's, on the CPU.

- A file the JAX package wrote, read by the port, and a file the port wrote
  (also through `python -m txt2vid_tpu_torch.data.packed`), read by the JAX
  package: byte-identical files and equal `get_batch` batches, evenly spaced
  and random frames, uint8 and normalised.
- The native reader against the numpy path, where g++ is present.
- BatchLoader with one seed yields the JAX BatchLoader's batches in its order;
  get_loader hands batch-level datasets to it.
- The training CLI end to end on `--device cpu` with a packed `--data` spec,
  as r9_session.sh passes one, and remat in both models.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cli import D, G, S, _iters
from txt2vid_tpu.data import BatchLoader as JaxBatchLoader
from txt2vid_tpu.data import packed as jax_packed
from txt2vid_tpu_torch.data import BatchLoader, Loader, get_loader, load_pickle, main
from txt2vid_tpu_torch.data import packed
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.train import gan

REPO = Path(__file__).resolve().parents[1]
CLIPS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny CLI run takes one intra-op thread, as test_torch_cli's do."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """16 synthetic clips of 8 frames (32x32x3), the vocabulary, and the two
    packed files: one the JAX package wrote, one the port wrote."""
    d = tmp_path_factory.mktemp("packed")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=CLIPS,
                      frame_size=(32, 32), num_frames=8, seed=11, num_channels=3)
    main(type("A", (), {"sents": str(d / "sent.pickle"), "out": str(d / "vocab.pickle")}))
    jax_ids = jax_packed.pack_directory(d / "videos", d / "jax.t2vc")
    port_ids = packed.pack_directory(d / "videos", d / "port.t2vc")
    assert jax_ids == port_ids and len(port_ids) == CLIPS
    return d


def test_the_two_packers_write_the_same_bytes(clips, tmp_path):
    assert (clips / "jax.t2vc").read_bytes() == (clips / "port.t2vc").read_bytes()
    assert load_pickle(clips / "jax.ids.pickle") == load_pickle(clips / "port.ids.pickle")
    res = subprocess.run([sys.executable, "-m", "txt2vid_tpu_torch.data.packed", "--dir",
                          str(clips / "videos"), "--out", str(tmp_path / "cli.t2vc")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"packed {CLIPS} videos" in res.stdout
    assert (tmp_path / "cli.t2vc").read_bytes() == (clips / "jax.t2vc").read_bytes()


@pytest.mark.parametrize("random_frames,normalize,frame_size,channels",
                         [(0, False, None, 3), (1, True, 16, 1), (1, False, 32, 1)],
                         ids=["even-uint8", "random-normalised", "random-luma"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_file(clips, writer, reader, random_frames,
                                            normalize, frame_size, channels):
    vocab = load_pickle(clips / "vocab.pickle")
    path = clips / f"{writer}.t2vc"
    kw = dict(vocab=vocab, anno=str(clips / "sent.pickle"), num_frames=4,
              frame_size=frame_size, num_channels=channels, normalize=normalize,
              random_frames=random_frames, num_threads=2)
    ds = {"jax": jax_packed.packed_dataset, "port": packed.packed_dataset}[reader](
        data=str(path), **kw)
    ref = jax_packed.packed_dataset(data=str(clips / "jax.t2vc"), **kw)
    assert len(ds) == len(ref) == CLIPS
    for idxs in ([0, 5, 3, 9], [15, 1, 2, 8]):
        got, want = ds.get_batch(np.asarray(idxs), 12), ref.get_batch(np.asarray(idxs), 12)
        assert got.keys() == want.keys() == {"video", "captions", "lengths"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    frames, caption = ds[7]
    want_frames, want_caption = ref[7]
    np.testing.assert_array_equal(frames, want_frames)
    np.testing.assert_array_equal(caption, want_caption)


def test_native_reader_matches_the_numpy_path(clips, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native reader")
    native = packed.PackedReader(clips / "port.t2vc", num_threads=4)
    assert native.native
    assert packed.native_library_path().exists()
    monkeypatch.setattr(packed, "_load_native", lambda: None)
    plain = packed.PackedReader(clips / "port.t2vc")
    assert not plain.native
    assert (native.num_videos, native.frame_shape) == (plain.num_videos, plain.frame_shape) \
        == (CLIPS, (32, 32, 3))
    rng = np.random.default_rng(4)
    vids = rng.integers(0, CLIPS, 6)
    fidx = np.sort(rng.integers(0, 8, (6, 5)), axis=1)
    np.testing.assert_array_equal(native.read_batch(vids, fidx), plain.read_batch(vids, fidx))
    assert [native.video_num_frames(i) for i in range(CLIPS)] == [8] * CLIPS
    with pytest.raises(RuntimeError, match="fc_read_batch"):
        native.read_batch(np.asarray([0]), np.asarray([[8]]))      # frame past T
    native.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_order_matches_jax(clips, workers):
    ds = packed.packed_dataset(data=str(clips / "port.t2vc"),
                               vocab=load_pickle(clips / "vocab.pickle"),
                               anno=str(clips / "sent.pickle"), num_frames=4,
                               normalize=False, num_threads=1)
    ours = BatchLoader(ds, batch_size=5, num_workers=workers, seed=9)
    ref = JaxBatchLoader(ds, batch_size=5, num_workers=workers, seed=9)
    assert len(ours) == len(ref) == 3
    for epoch in range(2):          # the generator carries across epochs
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"epoch {epoch} {k}")


def test_get_loader_dispatches_batch_level_datasets(clips):
    ds = packed.packed_dataset(data=str(clips / "port.t2vc"), num_frames=4)
    loader = get_loader(ds, batch_size=4, num_workers=2, seed=1)
    assert isinstance(loader, BatchLoader) and len(loader) == CLIPS // 4
    batch = next(iter(loader))
    assert batch.keys() == {"video"} and batch["video"].shape == (4, 4, 32, 32, 3)
    items = get_loader([(np.zeros((4, 8, 8, 3), np.float32), None)] * 4, batch_size=2)
    assert isinstance(items, Loader) and not isinstance(items, BatchLoader)


def test_training_cli_on_packed_data_with_remat(clips, tmp_path):
    spec = {"class": "txt2vid_tpu.data.packed.packed_dataset",
            "args": {"data": str(clips / "port.t2vc"), "num_frames": 4}}
    g = {**G, "args": {**G["args"], "remat": True}}
    d = {**D, "args": {**D["args"], "remat": True}}
    out = tmp_path / "run"
    gan.cli(["--device", "cpu", "--G", json.dumps(g), "--D", json.dumps(d),
             "--sent", json.dumps(S), "--data", json.dumps(spec),
             "--anno", str(clips / "sent.pickle"), "--vocab", str(clips / "vocab.pickle"),
             "--frame_sizes", "8", "16", "--subsample_input", "--num_channels", "3",
             "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--gp_lambda", "1.0",
             "--gp_every", "2", "--clip_grad", "100", "--clip_grad_split",
             "--g_ema", "0.999", "--batch_size", "4", "--epochs", "1", "--seed", "2",
             "--workers", "2", "--save_model_period", "2", "--log_period", "1",
             "--save_example_period", "4", "--sample_batch_size", "2", "--out", str(out),
             "--out_samples", str(out / "samples")])
    assert _iters(out) == [2, 4]
    assert (out / "samples" / "fake_ema_samples_epoch_000_iter_000004_16x16.png").exists()
