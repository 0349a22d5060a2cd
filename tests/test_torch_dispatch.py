"""--steps_per_dispatch, the EMA's decay**k, the SGD and end2end checkpoint
trees and utils/profiling, on the CPU.

- The training CLI with --steps_per_dispatch 2 and with 1, four steps each
  on the same batches (test_torch_cli's tiny specs): the checkpoints of
  iteration 4 are the same bytes.
- The trainer's chunk-end actions: a scripted step of k = 3 through the
  port's trainer and the JAX package's, the iterations where each saves and
  logs, and the per-step metrics each drains.
- Chunking drops a ragged batch and a trailing partial group, as JAX's
  prefetch_to_mesh(stack=k) does, and stacks the same chunks.
- make_ema_update(decay, k) against JAX's: one update of weight 1 - decay**k.
- JAX init_state trees under optax.sgd and under end2end (and
  end2end_d_only), written by JAX's save_state, restored into the port and
  written back: the same bytes; a state the port made restores in JAX's
  restore_state with its template, equal arrays.
- utils.profiling on the CPU: a Chrome trace with a span, and no
  device memory statistics.
"""

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cli import argv as cli_argv
from test_torch_train_step import DISC, ENC, FRAME_SIZES, GEN
from txt2vid_tpu.gan import ema as jax_ema
from txt2vid_tpu.gan import trainer as jax_trainer
from txt2vid_tpu.gan.cond_gan import CondGan as JaxCondGan
from txt2vid_tpu.gan.train_step import TrainConfig as JaxTrainConfig
from txt2vid_tpu.gan.train_step import init_state
from txt2vid_tpu.models import tganv2_cond as jax_tganv2_cond
from txt2vid_tpu.models.txt import Seq2Seq as JaxSeq2Seq
from txt2vid_tpu.parallel import mesh as jax_mesh
from txt2vid_tpu.utils import checkpoint as jax_checkpoint
from txt2vid_tpu_torch.convert import jax_state_to_torch, torch_state_to_jax
from txt2vid_tpu_torch.data import main as vocab_main
from txt2vid_tpu_torch.data.synthetic import generate_examples
from txt2vid_tpu_torch.gan import ema
from txt2vid_tpu_torch.gan import losses as port_losses
from txt2vid_tpu_torch.gan import trainer
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import (TrainConfig, adam, build_train_step,
                                              optimizer_params, sgd)
from txt2vid_tpu_torch.models import tganv2
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.train import gan
from txt2vid_tpu_torch.utils import checkpoint, profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    generate_examples(d / "videos", d / "sent.pickle", num_examples=16, frame_size=(32, 32),
                      num_frames=4, seed=5, num_channels=3)
    vocab_main(type("A", (), {"sents": str(d / "sent.pickle"),
                              "out": str(d / "vocab.pickle")}))
    return d


def test_two_steps_per_dispatch_equal_single_steps(data, tmp_path):
    """Four steps (the GP on 0 and 2, clip and EMA on) as two chunks of 2 and
    as four single steps: the iteration-4 checkpoints are the same bytes."""
    files = {}
    for k in (1, 2):
        out = tmp_path / f"k{k}"
        gan.cli(cli_argv(data, out, "--epochs", "1", "--save_model_period", "4",
                         "--save_example_period", "0", "--steps_per_dispatch", str(k)))
        (path,) = [p for p in out.iterdir() if p.name.startswith("iter_4_")
                   and p.suffix != ".ema"]
        files[k] = path
    assert files[1].name == files[2].name
    assert files[1].read_bytes() == files[2].read_bytes()


class _Recorder:
    """A checkpointer that records the paths it is asked to save."""

    def __init__(self, saved):
        self.saved = saved

    def save(self, state, path):
        self.saved.append(int(str(path).rsplit("iter_", 1)[1].split("_")[0]))
        return True

    def wait(self):
        pass


K, CHUNKS = 3, 10


def _params(tmp_path):
    return argparse.Namespace(
        out=str(tmp_path), out_samples=str(tmp_path / "s"), loss_window_size=20,
        log_period=5, save_model_period=4, save_example_period=0, save_initial=False,
        save_initial_examples=False, clip_grad=100.0, nan_abort=True, nan_abort_streak=100,
        nan_abort_window=200, nan_abort_window_count=20, g_ema=0.0, rss_limit_gb=0,
        steps_per_dispatch=K)


def _chunk_metrics(chunk):
    base = np.arange(K, dtype=np.float32) + K * chunk
    return {"loss_d": 1.0 + base, "loss_g": 2.0 + base, "grad_norm_d": 3.0 + base,
            "grad_norm_g": 4.0 + base}


def _jax_actions(tmp_path, monkeypatch):
    saved, logged = [], []
    monkeypatch.setattr(jax_trainer, "AsyncCheckpointer", lambda **kw: _Recorder(saved))
    monkeypatch.setattr(jax_trainer, "status", logged.append)

    class State:
        step = 0

    def step(state, batch, key):
        return state, _chunk_metrics(batch)

    jax_trainer.train(gan=None, state=State(), train_step=step, num_epoch=1,
                      dataset=list(range(CHUNKS)), params=_params(tmp_path), base_key=0)
    return saved, logged


def _port_actions(tmp_path, monkeypatch):
    saved, logged = [], []
    monkeypatch.setattr(trainer, "AsyncCheckpointer", lambda **kw: _Recorder(saved))
    monkeypatch.setattr(trainer, "torch_state_to_jax", lambda step: {})
    monkeypatch.setattr(trainer, "status", logged.append)

    class Step:
        step = 0

        def __call__(self, chunk):
            return {k: torch.from_numpy(v) for k, v in _chunk_metrics(chunk).items()}

    trainer.train(train_step=Step(), num_epoch=1, dataset=list(range(CHUNKS)),
                  params=_params(tmp_path))
    return saved, logged


def test_chunk_end_actions_as_jax_picks_them(tmp_path, monkeypatch):
    """k = 3, save period 4, log period 5: both trainers save at the same
    chunk ends (6, 9, 12, 18, 21, 24, 30, and the final 30) and log at the
    same iterations (6, 12, 15, 21, 27, 30) the same rolling averages of
    each step's losses and norms, drained from the (k,) chunks."""
    with monkeypatch.context() as mp:
        jax_saved, jax_logged = _jax_actions(tmp_path / "jax", mp)
    with monkeypatch.context() as mp:
        saved, logged = _port_actions(tmp_path / "port", mp)
    assert saved == jax_saved == [6, 9, 12, 18, 21, 24, 30, 30]

    def iters(lines):
        return [line.split(" - ")[1] for line in lines if "Loss_D" in line]
    assert iters(logged) == iters(jax_logged)
    assert [int(s.split("Iter ")[1].split(",")[0]) for s in iters(logged)] == [6, 12, 15, 21,
                                                                                 27, 30]
    # the window of 20 at iteration 30 holds steps 11..30: loss_d 11.0 .. 30.0
    assert "Loss_D: 20.5000 Loss_G: 21.5000 |g|D: 22.50 |g|G: 23.50" in iters(logged)[-1]


def _batch(lead, i):
    return {"captions": np.full((lead, 3), i, np.int32), "lengths": np.full((lead,), i, np.int32),
            "video": np.full((lead, 2, 4, 4, 1), i, np.uint8)}


def test_chunking_drops_ragged_batches_and_partial_groups():
    """Leading sizes 8 8 3 8 8 8 8 8 at k = 2: the 3 is dropped, the last 8
    has no partner; the chunks are JAX's prefetch_to_mesh(stack=2)'s (on
    its mesh of the suite's 8 host devices)."""
    sizes = [8, 8, 3, 8, 8, 8, 8, 8]
    got = list(gan.stack_batches((_batch(n, i) for i, n in enumerate(sizes)), 2))
    mesh = jax_mesh.make_mesh(sp=1, fsdp=1)
    want = list(jax_mesh.prefetch_to_mesh((_batch(n, i) for i, n in enumerate(sizes)), mesh,
                                          depth=0, stack=2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].shape[:2] == (2, 8)
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    assert [int(g["video"][i, 0, 0, 0, 0, 0]) for g in got for i in range(2)] == [0, 1, 3, 4,
                                                                                   5, 6]


@pytest.mark.parametrize("k", [1, 4])
def test_ema_decay_power_k(k):
    """One update of weight 1 - decay**k, as JAX's make_ema_update(decay, k)."""
    rng = np.random.default_rng(k)
    lin = torch.nn.Linear(5, 3)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    start = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for n, p in lin.named_parameters()}
    avg = {n: v.clone() for n, v in start.items()}
    ema.make_ema_update(0.9, k)(avg, lin)
    want = jax_ema.make_ema_update(0.9, k)(
        {n: jnp.asarray(v.numpy()) for n, v in start.items()},
        {n: jnp.asarray(p.detach().numpy()) for n, p in lin.named_parameters()})
    for n in avg:
        np.testing.assert_allclose(avg[n].numpy(), np.asarray(want[n]), rtol=0, atol=1e-7)
        w = 1 - 0.9 ** k
        np.testing.assert_allclose(
            avg[n].numpy(), start[n].numpy() + w * (dict(lin.named_parameters())[n]
                                                    .detach().numpy() - start[n].numpy()),
            rtol=0, atol=1e-6)


B = 4
TREES = {
    "sgd": dict(optimizer="sgd"),
    "end2end": dict(end2end=True),
    "end2end_d_only": dict(end2end=True, end2end_txt_in_g=False),
}


@functools.cache
def _jax_state(kind):
    gen = jax_tganv2_cond.MultiScaleGen(**GEN, use_pallas=False)
    disc = jax_tganv2_cond.MultiScaleDiscrim(**DISC, use_pallas=False)
    gan_ = JaxCondGan(gen=gen, discrims=[disc], cond_encoder=JaxSeq2Seq(**ENC))
    cfg = {k: v for k, v in TREES[kind].items() if k != "optimizer"}
    opt = (optax.sgd(2e-4, momentum=0.5) if TREES[kind].get("optimizer") == "sgd"
           else optax.adam(2e-4, b1=0.5, b2=0.999))
    rng = np.random.default_rng(1)
    batch = {"video": rng.integers(0, 255, (B, 8, 32, 32, 3)).astype(np.uint8),
             "captions": rng.integers(1, ENC["vocab_size"], (B, 6)).astype(np.int32),
             "lengths": np.full((B,), 6, np.int32)}
    state = init_state(gan_, jax.random.key(0), batch, opt, opt,
                       JaxTrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                                      latent_size=GEN["latent_size"], **cfg))
    # nonzero optimizer state and step, so traces, moments and counts are checked
    return state.replace(step=jnp.asarray(6, jnp.int32), opt_g_state=jax.tree_util.tree_map(
        lambda a: a + 0.5 if a.dtype == jnp.float32 else a + 3, state.opt_g_state),
        opt_d_state=jax.tree_util.tree_map(
        lambda a: a * 0.25 + 0.125 if a.dtype == jnp.float32 else a + 3, state.opt_d_state))


def _port_step(kind, seed=0):
    gen = init_from_seed(tganv2.MultiScaleGen(**GEN, with_non_local=True), seed)
    disc = init_from_seed(tganv2.MultiScaleDiscrim(**DISC), seed + 1)
    enc = init_from_seed(Seq2Seq(**ENC), seed + 2)
    gan_ = CondGan(gen, enc, discrims=[disc])
    cfg = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True,
                      latent_size=GEN["latent_size"],
                      **{k: v for k, v in TREES[kind].items() if k != "optimizer"})
    g_params, d_params = optimizer_params(gan_, cfg)
    make = sgd if TREES[kind].get("optimizer") == "sgd" else adam
    return build_train_step(gan_, port_losses.RSGANLoss(), make(g_params), make(d_params), cfg)


@pytest.mark.parametrize("kind", list(TREES))
def test_optimizer_trees_round_trip_byte_for_byte(kind, tmp_path):
    state = _jax_state(kind)
    path = tmp_path / "iter_6_jax"
    jax_checkpoint.save_state(state, str(path))
    step = _port_step(kind)
    jax_state_to_torch(checkpoint.restore_state(torch_state_to_jax(step), path), step)
    assert step.step == 6
    out = checkpoint.save_state(torch_state_to_jax(step), tmp_path / "iter_6_port")
    with open(out, "rb") as f:
        assert path.read_bytes() == f.read()
    txt = step.gan.cond_encoder.encoder.embed.weight
    if kind == "sgd":
        assert set(step.opt_g.state[next(step.gan.gen.parameters())]) == {"momentum_buffer"}
    else:
        assert (txt in step.opt_g.state) == (kind == "end2end") and txt in step.opt_d.state


@pytest.mark.parametrize("kind", list(TREES))
def test_jax_restores_the_ports_optimizer_trees(kind, tmp_path):
    """A state the port made (two steps' worth of traces or moments) opens in
    JAX's restore_state with JAX's template for that optimizer, equal arrays."""
    step = _port_step(kind, seed=4)
    opts = [(step.opt_g, step.opt_g.param_groups[0]["params"]),
            (step.opt_d, step.opt_d.param_groups[0]["params"])]
    for opt, params in opts:
        for i, p in enumerate(params):
            opt.state[p] = ({"momentum_buffer": torch.full_like(p, 0.1 * i)} if kind == "sgd"
                            else {"step": torch.tensor(2.0),
                                  "exp_avg": torch.full_like(p, 0.1 * i),
                                  "exp_avg_sq": torch.full_like(p, 0.01)})
    step.step = 2
    tree = checkpoint.to_host(torch_state_to_jax(step))
    out = checkpoint.save_state(torch_state_to_jax(step), tmp_path / "iter_2_port")
    restored = jax_checkpoint.restore_state(_jax_state(kind), str(out))
    assert int(restored.step) == 2
    from flax import serialization
    flat = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray, restored))

    def check(a, b, where=""):
        if isinstance(a, dict):
            assert set(a) == set(b), where
            for k in a:
                check(a[k], b[k], f"{where}/{k}")
        elif a is None:
            assert b is None, where
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
    check(tree, flat)
    g_tree = tree["opt_g_state"]["0"]["trace" if kind == "sgd" else "mu"]
    assert ("txt" in g_tree) == (kind == "end2end")


def test_profiling_on_the_cpu(tmp_path):
    """trace writes a Chrome trace holding a span and records it with its
    step; without a card there are no device memory statistics, as the JAX
    package reports it."""
    x = torch.randn(64, 64)
    profiling.clear()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("trainer.step", step=3):
            (x @ x).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "trainer.step" for e in events)
    assert any(e.key == "trainer.step" for e in prof.key_averages())
    [record] = profiling.spans()
    assert (record.name, record.step, record.device_ms) == ("trainer.step", 3, None)
    profiling.clear()
    assert profiling.device_memory_stats() == {}
    assert profiling.format_memory_stats() == "no device memory stats"


def test_the_slice_imports_no_jax():
    """The device cache, the profiler, the step and the training CLI import
    neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import importlib, sys\n"
            "for n in ('txt2vid_tpu_torch.data.device_cache', 'txt2vid_tpu_torch.utils.profiling',\n"
            "          'txt2vid_tpu_torch.gan.train_step', 'txt2vid_tpu_torch.train.gan'):\n"
            "    importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'txt2vid_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
