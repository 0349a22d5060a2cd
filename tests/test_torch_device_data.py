"""The port's device-resident dataset (txt2vid_tpu_torch/data/device_cache.py)
against the JAX package's (txt2vid_tpu/data/device_cache.py), on the CPU.

- `from_dataset` over a small packed file (12 synthetic clips of 8 frames,
  32x32x3, read at 16 px): the clips, the pair->video map, the caption
  matrix and the lengths, byte for byte as JAX's.
- `assemble` fed the pair indices and the frame phase that JAX's traced
  assembler draws from its key (one split: randint of B pairs, randint of the
  phase): the same batch as JAX's, byte for byte, on the random grid and the
  even one.
- `host_batch` and `DeviceEpochIterator` (its length and its rotating host
  batches from np.random.default_rng(seed)) as JAX's.
- A train step through DeviceDataStep equals, bit for bit, the same step on
  `host_batch` of the indices it drew, copied to the device as the loader's
  batches are (train/gan.device_batches).
All comparisons are exact.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import DISC, FRAME_SIZES, GEN
from txt2vid_tpu.data import device_cache as jax_cache
from txt2vid_tpu.data import packed as jax_packed
from txt2vid_tpu_torch.data import build_vocab, load_pickle, packed
from txt2vid_tpu_torch.data.device_cache import (DeviceDataStep, DeviceEpochIterator,
                                                 DeviceVideoData)
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.train.gan import device_batches

CLIPS, B = 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("device_data")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=CLIPS,
                      frame_size=(32, 32), num_frames=8, seed=13, num_channels=3)
    packed.pack_directory(d / "videos", d / "clips.t2vc")
    sents = load_pickle(d / "sent.pickle")
    return d, build_vocab([s for v in sents.values() for s in v])


def datasets(clips, num_frames, frame_size=16):
    d, vocab = clips
    kw = dict(vocab=vocab, captions=str(d / "sent.pickle"), num_frames=num_frames,
              frame_size=frame_size, num_channels=3, normalize=False, num_threads=2)
    return (packed.PackedVideoDataset(d / "clips.t2vc", **kw),
            jax_packed.PackedVideoDataset(d / "clips.t2vc", **kw))


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
        assert g.dtype == w.dtype or (k == "captions" and g.dtype == np.int64), k


@pytest.mark.parametrize("random_phase", [False, True])
def test_from_dataset_byte_for_byte(clips, random_phase):
    port_ds, jax_ds = datasets(clips, 4)
    got = DeviceVideoData.from_dataset(port_ds, random_phase=random_phase)
    want = jax_cache.DeviceVideoData.from_dataset(jax_ds, random_phase=random_phase)
    assert got.videos.dtype == want.videos.dtype == np.uint8
    assert got.videos.shape == want.videos.shape == (CLIPS, 8, 16, 16, 3)
    for a in ("videos", "vid_idx", "captions", "lengths"):
        g, w = getattr(got, a), getattr(want, a)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), a
    assert got.num_pairs == want.num_pairs and got.frame_stride == want._frame_stride == 2


@pytest.mark.parametrize("random_phase,num_frames", [(True, 4), (False, 4), (True, 8)])
def test_assemble_with_jax_draws(clips, random_phase, num_frames):
    """JAX's traced assembler at three keys; the port's assemble fed the
    indices and the phase JAX drew there."""
    port_ds, jax_ds = datasets(clips, num_frames)
    port = DeviceVideoData.from_dataset(port_ds, random_phase=random_phase)
    ref = jax_cache.DeviceVideoData.from_dataset(jax_ds, random_phase=random_phase)
    arrays = ref.device_arrays()
    port.device_arrays("cpu")
    phases = set()
    for k in range(3):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), k), 0xda7a)
        want = ref.assemble(arrays, key, B)
        ki, kp = jax.random.split(key)
        idx = np.asarray(jax.random.randint(ki, (B,), 0, ref.num_pairs))
        phase = (int(jax.random.randint(kp, (), 0, ref._frame_stride))
                 if random_phase and num_frames < 8 else 0)
        phases.add(phase)
        got = port.assemble(torch.from_numpy(idx), phase)
        assert got["video"].dtype == torch.uint8
        _same(got, {k2: np.asarray(v) for k2, v in want.items()})
    assert phases == ({0, 1} if random_phase and num_frames < 8 else {0})


def test_host_batch_and_epoch_iterator(clips):
    port_ds, jax_ds = datasets(clips, 4)
    port = DeviceVideoData.from_dataset(port_ds)
    ref = jax_cache.DeviceVideoData.from_dataset(jax_ds)
    idxs = np.array([0, 5, 13, 2])          # 13 wraps modulo num_pairs
    _same(port.host_batch(idxs), ref.host_batch(idxs))
    for batch_size, seed in ((B, 3), (5, 0), (CLIPS * 2, 1)):
        it, want = (DeviceEpochIterator(port, batch_size, seed=seed),
                    jax_cache.DeviceEpochIterator(ref, batch_size, seed=seed))
        assert len(it) == len(want) == max(port.num_pairs // batch_size, 1)
        for got_b, want_b in zip(it, want, strict=True):
            _same(got_b, want_b)


def test_draws_are_seeded_by_seed_and_step(clips):
    """(seed, step, 0xda7a): the same indices and phase for the same step,
    others for another step or seed, within range."""
    port_ds, _ = datasets(clips, 4)
    data = DeviceVideoData.from_dataset(port_ds, random_phase=True)
    a, pa = data.draw(3, 5, B)
    b, pb = data.draw(3, 5, B)
    assert torch.equal(a, b) and pa == pb
    assert not torch.equal(a, data.draw(3, 6, B)[0]) or not torch.equal(a, data.draw(4, 5, B)[0])
    draws = [data.draw(0, s, B) for s in range(20)]
    assert all(0 <= int(i.min()) and int(i.max()) < data.num_pairs for i, _ in draws)
    assert {p for _, p in draws} == {0, 1}


def _step(vocab_size, seed=5):
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), 1)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), 2)
    enc = init_from_seed(Seq2Seq(vocab_size=vocab_size, embed_size=8, hidden_size=16,
                                 num_layers=1), 3)
    return build_train_step(CondGan(gen, enc, discrims=[disc]), port_losses.RSGANLoss(),
                            adam(gen.parameters()), adam(disc.parameters()),
                            TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                        latent_size=GEN["latent_size"]), seed=seed)


def test_device_data_step_equals_the_loader_step(clips):
    """Two steps through DeviceDataStep against the same two steps on the
    host batches of the drawn indices through device_batches: the same
    losses and every parameter, statistic and moment bit for bit."""
    port_ds, _ = datasets(clips, 8, frame_size=32)
    data = DeviceVideoData.from_dataset(port_ds)
    data.device_arrays("cpu")
    assert data.nbytes == data.videos.nbytes + 8 * (data.num_pairs + data.captions.size)
    vocab_size = len(clips[1])
    on_device, plain = DeviceDataStep(_step(vocab_size), data, B, seed=9), _step(vocab_size)
    for s in range(2):
        idx, phase = data.draw(9, s, B)
        assert phase == 0
        (batch,) = device_batches([data.host_batch(idx.numpy())], torch.device("cpu"), 0)
        m_dev, m_plain = on_device({}), plain(batch)
        assert {k: float(v) for k, v in m_dev.items()} == {k: float(v) for k, v in m_plain.items()}
    assert on_device.step == plain.step == 2
    for a, b in ((on_device.gan.gen, plain.gan.gen), (on_device.gan.discrims[0],
                                                      plain.gan.discrims[0])):
        for (n, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), n
    for oa, ob in ((on_device.opt_g, plain.opt_g), (on_device.opt_d, plain.opt_d)):
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert torch.equal(oa.state[pa]["exp_avg"], ob.state[pb]["exp_avg"])
