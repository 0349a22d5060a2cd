"""Checkpoints between the JAX package and the port, on the CPU.

- The port's msgpack codec (utils/msgpack.py) against flax.serialization:
  the same bytes for the same tree (every msgpack type a state tree uses,
  ext 1 and ext 3, the chunked form of large arrays), and each reads the
  other's bytes.
- A JAX train state from `init_state` written by JAX's `save_state` is
  restored into the port's modules and optimizers, written back by the
  port's `save_state`, and the two files are byte for byte equal; JAX's
  `restore_state(template)` reads the port's file with equal arrays.
- The `.ema` sibling both ways, `latest_checkpoint` (skips `.ema`) and the
  AsyncCheckpointer's one slot.
All comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from test_torch_train_step import DISC, ENC, FRAME_SIZES, GEN
from txt2vid_tpu.gan import ema as jax_ema
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import init_state
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch.convert import jax_state_to_torch, torch_state_to_jax
from txt2vid_tpu_torch.gan import ema
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.utils import checkpoint, msgpack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny models run on one intra-op thread: beside other test
    processes, torch's thread pool oversubscribes the cores and runs many
    times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B = 4


def _equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=True))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def _sample_tree(rng):
    """Every leaf type of a state tree; keys sorted, as flax's serializer sorts."""
    tree = {
        "arrays": {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
                   "f": rng.normal(size=(3, 4, 5)).astype(np.float32),
                   "f64": rng.normal(size=(7,)),
                   "i64": np.array([-2**40, 2**40], np.int64),
                   "scalar0d": np.array(7, np.int32),
                   "u8": rng.integers(0, 255, (2, 2, 3)).astype(np.uint8),
                   "zero": np.zeros((0, 3), np.float32)},
        "big": {"long": rng.normal(size=(70000,)).astype(np.float32)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33,
                 -128, -129, -32768, -32769, -2**31, -2**31 - 1],
        "misc": {"bin": b"\x00\x01" * 200, "bool": True, "empty": {}, "false": False,
                 "float": 1.25, "none": None, "np_scalar": np.float32(2.5),
                 "str": "é" * 40},
        "many": {str(i): np.float32(i) for i in sorted(range(20), key=str)},
    }
    return {k: tree[k] for k in sorted(tree)}


def test_codec_writes_flax_bytes_and_reads_them():
    tree = _sample_tree(np.random.default_rng(0))
    ref = serialization.msgpack_serialize(tree)
    assert msgpack.packb(serialization.msgpack_restore(ref)) == ref
    assert _equal(msgpack.unpackb(ref), serialization.msgpack_restore(ref))
    assert _equal(serialization.msgpack_restore(msgpack.packb(tree)),
                  serialization.msgpack_restore(ref))


def test_codec_chunked_arrays(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes: flax's chunked form both ways."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 256)
    tree = {"s": np.ones(3), "w": np.arange(1000, dtype=np.float32).reshape(10, 100)}
    ref = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == ref
    back = msgpack.unpackb(ref)
    assert np.array_equal(back["w"], tree["w"]) and back["w"].shape == (10, 100)


def test_codec_reads_bfloat16_as_float32():
    vals = jnp.asarray([0.0, 1 / 3, -2.5, 1e30], jnp.bfloat16)
    got = msgpack.unpackb(serialization.msgpack_serialize({"m": np.asarray(vals)}))["m"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(vals.astype(jnp.float32)))


def _jax_gan():
    gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=False)
    disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False)
    return JaxCondGan(gen=gen, discrims=[disc], cond_encoder=JaxSeq2Seq(**ENC))


def _port_step(seed=0):
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), seed)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), seed + 1)
    enc = init_from_seed(Seq2Seq(**ENC), seed + 2)
    cfg = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                      latent_size=GEN["latent_size"])
    return build_train_step(CondGan(gen, enc, discrims=[disc]), port_losses.RSGANLoss(),
                            adam(gen.parameters()), adam(disc.parameters()), cfg)


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """A JAX init_state, its file from JAX's save_state, and the template."""
    opt = optax.adam(2e-4, b1=0.5, b2=0.999)
    rng = np.random.default_rng(1)
    batch = {"video": rng.integers(0, 255, (B, 8, 32, 32, 3)).astype(np.uint8),
             "captions": rng.integers(1, ENC["vocab_size"], (B, 6)).astype(np.int32),
             "lengths": np.full((B,), 6, np.int32)}
    cfg = JaxTrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                         latent_size=GEN["latent_size"])
    state = init_state(_jax_gan(), jax.random.key(0), batch, opt, opt, cfg)
    # nonzero Adam state and step, so counts and moments are checked too
    state = state.replace(step=jnp.asarray(6, jnp.int32), opt_g_state=jax.tree_util.tree_map(
        lambda a: a + 0.5 if a.dtype == jnp.float32 else a + 3, state.opt_g_state),
        opt_d_state=jax.tree_util.tree_map(
        lambda a: a * 0.25 + 0.125 if a.dtype == jnp.float32 else a + 3, state.opt_d_state))
    path = tmp_path_factory.mktemp("ckpt") / "iter_6_lossG_1.0000_lossD_1.0000"
    jax_checkpoint.save_state(state, str(path))
    return state, path


def test_jax_checkpoint_round_trips_through_the_port_byte_for_byte(jax_init, tmp_path):
    state, path = jax_init
    step = _port_step()
    jax_state_to_torch(checkpoint.restore_state(torch_state_to_jax(step), path), step)
    assert step.step == 6
    p = next(step.gan.gen.parameters())
    assert int(step.opt_g.state[p]["step"]) == 3
    out = checkpoint.save_state(torch_state_to_jax(step), tmp_path / "iter_6_port")
    with open(path, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_jax_restores_a_port_checkpoint(jax_init, tmp_path):
    """A state the port made itself (its own init, two optimizer steps' worth
    of moments) opens in JAX's restore_state with the JAX template, equal
    arrays, and the template's dtypes (count int32)."""
    state, _ = jax_init
    step = _port_step(seed=4)
    for opt, mod in ((step.opt_g, step.gan.gen), (step.opt_d, step.gan.discrims[0])):
        for i, p in enumerate(mod.parameters()):
            opt.state[p] = {"step": torch.tensor(2.0), "exp_avg": torch.full_like(p, 0.1 * i),
                            "exp_avg_sq": torch.full_like(p, 0.01)}
    step.step = 2
    tree = checkpoint.to_host(torch_state_to_jax(step))
    out = checkpoint.save_state(torch_state_to_jax(step), tmp_path / "iter_2_port")
    restored = jax_checkpoint.restore_state(state, out)
    assert int(restored.step) == 2 and restored.step.dtype == np.int32
    assert int(restored.opt_d_state[0].count) == 2
    flat_r = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, restored))

    def check(a, b, where=""):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                check(a[k], b[k], f"{where}/{k}")
        elif a is None:
            assert b is None, where
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    check(tree, flat_r)


def test_ema_sibling_both_ways(jax_init, tmp_path):
    state, _ = jax_init
    step = _port_step(seed=7)
    avg = ema.init_ema(step.gan.gen)
    with torch.no_grad():
        for v in avg.values():
            v.mul_(0.5).add_(0.25)
    base = tmp_path / "iter_3_lossG_0.5000_lossD_0.5000"
    assert ema.save_ema(avg, base) == str(base) + ".ema"
    got = ema.load_ema(base, ema.init_ema(step.gan.gen))
    assert all(torch.equal(got[n], v) for n, v in avg.items())
    jax_avg = jax_ema.load_ema(str(base), state.g_vars["params"])
    assert _equal(serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, jax_avg)),
                  checkpoint.to_host(ema.ema_tree(avg)))
    assert ema.load_ema(tmp_path / "iter_9", avg) is None


def test_latest_checkpoint_skips_siblings(tmp_path):
    for name in ("iter_4_lossG_1_lossD_1", "iter_12_lossG_1_lossD_1",
                 "iter_12_lossG_1_lossD_1.ema", "iter_30_lossG_1_lossD_1.ema", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.latest_checkpoint(tmp_path) == str(tmp_path / "iter_12_lossG_1_lossD_1")
    assert checkpoint.latest_checkpoint(tmp_path / "missing") is None


def test_async_checkpointer_keeps_the_latest_waiting_save(tmp_path):
    import threading
    gate, written = threading.Event(), []

    def slow_save(state, path):
        gate.wait(10)
        written.append((path, int(state["x"])))

    ck = checkpoint.AsyncCheckpointer(save_fn=slow_save)
    x = torch.zeros(())
    assert ck.save({"x": x}, "a") is True
    x += 1
    assert ck.save({"x": x}, "b") is False
    x += 1
    assert ck.save({"x": x}, "c") is False      # replaces "b" in the slot
    gate.set()
    ck.wait()
    assert written == [("a", 0), ("c", 2)]


def test_restore_rejects_a_mismatched_state(jax_init):
    _, path = jax_init
    template = torch_state_to_jax(_port_step())
    template["g_vars"]["params"]["fc"]["kernel"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="fc/kernel"):
        checkpoint.restore_state(template, path)


def test_sent_weights_from_a_jax_txt_checkpoint(tmp_path):
    """A txt-pretrain file as train/txt.py writes it ({"optim", "txt"}) loads
    into the port's Seq2Seq (to_vocab into its decoder Linear), and the port encodes
    as the JAX encoder does (1e-5 of the scale)."""
    from test_torch_models import jax_variables
    from txt2vid_tpu_torch.convert import load_encoder_vars
    rng = np.random.default_rng(2)
    caps = rng.integers(1, ENC["vocab_size"], (3, 6)).astype(np.int32)
    lens = np.array([6, 2, 4], np.int32)
    for i, n in enumerate(lens):
        caps[i, n:] = 0
    enc = JaxSeq2Seq(**ENC)
    t_vars = jax_variables(enc, 5, jnp.asarray(caps), jnp.asarray(lens))
    path = tmp_path / "txt_final"
    path.write_bytes(serialization.to_bytes({"optim": {"count": np.array(3, np.int32)},
                                             "txt": t_vars}))
    port = Seq2Seq(**ENC)
    with torch.no_grad():
        load_encoder_vars(port, checkpoint.restore_txt_vars(path))
    tv = t_vars["params"]["encoder"]["to_vocab"]
    assert torch.equal(port.encoder.to_vocab.weight, torch.from_numpy(np.asarray(tv["kernel"]).T))
    ref = np.asarray(enc.apply(t_vars, jnp.asarray(caps), lengths=jnp.asarray(lens),
                               method=enc.encode)[2])
    got = port.encode(torch.from_numpy(caps).long(), torch.from_numpy(lens))[2].detach().numpy()
    assert float(np.abs(ref - got).max()) <= 1e-5 * max(1.0, float(np.abs(ref).max()))
