"""--device_data and --steps_per_dispatch across ranks (data/device_cache.py,
gan/train_step.ChunkStep, train/gan.py, gan/trainer.py) on the CPU: gloo
groups through tests/torch_parallel_worker.py and test_torch_parallel's
spawn, at test_torch_parallel.py's tiny spec and command line.

- Assembly: JAX's DeviceVideoData.assemble jitted on a dp=2 mesh and on a
  dp=2 x sp=2 x fsdp=2 mesh of the conftest's virtual CPU devices, the
  batch resharded to dp as jit_device_data_step reshards it: each device's
  shard equals, byte for byte, the batch that the port's rank at the same
  mesh position assembles (DeviceDataStep under a stand-in mesh of that
  rank's dp index) from the indices and the phase JAX drew; the sp and fsdp
  peers of a rank take its rows.
- 2 --device_data steps at dp=2 (global batch 6, 3 per rank): bit for bit
  the 2 dp=2 steps on the host batches of the same draws, each rank's rows
  cut by dp_slice as the loader's ShardedView feeds them; each against the
  one-process --device_data step from the same state (the initial one, then
  the dp=2 state after step 0: across two steps the tiny generator's
  ill-conditioned G gradients carry the first step's rounding into the
  second, 5.3e-3 of a leaf scale on another host's CPU), at
  test_torch_parallel.py's tolerances for norms (1e-4 relative) and first
  moments (D's 1e-3, G's 3e-3 of the leaf scale; measured 7.2e-4 and
  3.9e-4), and at twice its losses' 1e-5: on these clips the dp=2 step,
  the loader's bit for bit, reads loss_g 1.06e-5 from one process at step
  0; both ranks end bit for bit equal.
- The training CLI under torchrun's environment: --fsdp 2 --device_data
  against one process (rank 0's checkpoints and .ema byte for byte);
  --steps_per_dispatch 2 at dp=2, 4 steps in 2 chunks, against 4 single
  steps at dp=2 (the checkpoint at the iterations JAX's trainer picks, byte
  for byte); --fsdp 2 --steps_per_dispatch 2 --g_ema against one process
  (the .ema of decay**2 once per chunk byte for byte). The CLI runs start
  side by side.
Every fixture removes its rank results and checkpoints at teardown.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_parallel import (DISC, ENC, GEN, ROOT, SPAWN_TIMEOUT, check_metrics,  # noqa: F401
                                 check_moments, checkpoints, cli_argv, cli_data, first_moments,
                                 flat, needs_jax_package, port_config, port_state, spawn)
from txt2vid_tpu_torch.data.device_cache import DeviceDataStep, DeviceVideoData

B = 6               # the global batch of the device-data steps (3 per rank)


def clips(seed=0, n=12, pairs=16, t=8):
    """DeviceVideoData's arguments: n uint8 clips of t frames at the tiny
    spec's 32 px, `pairs` captions over them."""
    rng = np.random.default_rng(seed)
    caps = rng.integers(1, ENC["vocab_size"], (pairs, 6)).astype(np.int32)
    lens = rng.integers(2, 7, pairs).astype(np.int32)
    caps[np.arange(6)[None, :] >= lens[:, None]] = 0
    return dict(videos=rng.integers(0, 256, (n, t, 32, 32, 3), dtype=np.uint8),
                vid_idx=rng.integers(0, n, pairs), captions=caps, lengths=lens,
                num_frames=GEN["num_frames"])


def rank_batch(data, dp_index, dp, idx, phase):
    """The batch the rank of dp index `dp_index` assembles when the global
    draw is (idx, phase)."""
    inner = types.SimpleNamespace(step=0, mesh=types.SimpleNamespace(dp_index=dp_index, dp=dp))
    data.draw = lambda seed, step, batch_size: (torch.from_numpy(idx), phase)
    return DeviceDataStep(inner, data, len(idx)).batch()


@pytest.mark.parametrize("sp,fsdp", [(1, 1), (2, 2)], ids=["dp2", "dp2_sp2_fsdp2"])
def test_rank_batches_are_jax_dp_shards(sp, fsdp):
    """Three keys, the random frame phase: JAX's shard on the device at mesh
    position (d, s, f) is the batch the port's rank there assembles."""
    needs_jax_package()
    import jax
    from txt2vid_tpu.data import device_cache as jax_cache
    from txt2vid_tpu.parallel.mesh import batch_sharding, make_mesh
    args = dict(clips(), num_frames=4, random_phase=True)
    ref, port = jax_cache.DeviceVideoData(**args), DeviceVideoData(**args)
    port.device_arrays("cpu")
    dp = 2
    mesh = make_mesh(n_devices=dp * sp * fsdp, sp=sp, fsdp=fsdp)
    arrays = ref.device_arrays(mesh)
    bs = batch_sharding(mesh)
    assemble = jax.jit(lambda a, key: jax.tree_util.tree_map(
        lambda x: jax.lax.with_sharding_constraint(x, bs), ref.assemble(a, key, B)))
    grid = np.asarray(mesh.devices).reshape(dp, sp, fsdp)
    phases = set()
    for k in range(3):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), k), 0xda7a)
        want = assemble(arrays, key)
        ki, kp = jax.random.split(key)
        idx = np.asarray(jax.random.randint(ki, (B,), 0, ref.num_pairs)).astype(np.int64)
        phase = int(jax.random.randint(kp, (), 0, ref._frame_stride))
        phases.add(phase)
        for name, arr in want.items():
            assert len(arr.addressable_shards) == dp * sp * fsdp
            for shard in arr.addressable_shards:
                d, s, f = (int(i) for i in np.argwhere(grid == shard.device)[0])
                assert shard.index[0] == slice(d * B // dp, (d + 1) * B // dp), (name, d)
                got = rank_batch(port, d, dp, idx, phase)[name].numpy()
                np.testing.assert_array_equal(got, np.asarray(shard.data).astype(got.dtype),
                                              err_msg=f"{name} at ({d}, {s}, {f})")
    assert phases == {0, 1}


# ------------------------------------------------------- device-data steps

@pytest.fixture(scope="module")
def device_runs(tmp_path_factory):
    """2 device-data steps on 2 gloo ranks (dp=2), from the port's init
    (every gamma 0.5) in test_torch_parallel's state file, and each step on
    one process from the state the dp=2 run started it from."""
    from test_torch_parallel import run_ranks
    from torch_parallel_worker import run_device_steps
    tmp = tmp_path_factory.mktemp("device_steps")
    port_state(tmp / "state")
    job = dict(kind="device_steps", gen=GEN, disc=DISC, enc=ENC, config=port_config(),
               loss="RSGANLoss", state=str(tmp / "state"), data=clips(1), batch_size=B,
               data_seed=9, steps=2, mesh={})
    ranks = run_ranks([dict(job, save_to=str(tmp)), dict(job, loader=True)], 2, tmp)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = [run_device_steps(dict(job, mesh=None, steps=1, state=str(start)))
               for start in (tmp / "state", tmp / "step0")]
    finally:
        torch.set_num_threads(n)
    yield {"one": one, "dp": [r[0] for r in ranks], "dp_loader": [r[1] for r in ranks]}
    shutil.rmtree(tmp, ignore_errors=True)


def test_dp2_device_data_steps_are_the_loaders_dp2_steps(device_runs):
    for dev, loader in zip(device_runs["dp"], device_runs["dp_loader"], strict=True):
        assert dev["metrics"] == loader["metrics"]
        a, b = flat(dev["state"]), flat(loader["state"])
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_dp2_device_data_steps_match_the_one_process_steps(device_runs):
    ranks = device_runs["dp"]
    assert [r["local_batch"] for r in ranks] == [B // 2] * 2
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 0)]
    for s, one in enumerate(device_runs["one"]):
        assert one["local_batch"] == B
        what = f"device data dp2 step {s}"
        for r in ranks:
            check_metrics(one["metrics"][0], r["metrics"][s], 2e-5, what, norm_tol=1e-4)
        for side, tol in (("d", 1e-3), ("g", 3e-3)):
            check_moments(first_moments(one["state"], side),
                          first_moments(ranks[0]["states"][s], side), tol, f"{what} {side}")


def test_dp2_device_data_ranks_end_identical(device_runs):
    a, b = (flat(r["state"]) for r in device_runs["dp"])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert device_runs["dp"][0]["metrics"] == device_runs["dp"][1]["metrics"]


# ----------------------------------------------------------- the training CLI

def packed_argv(data, out, *extra):
    """cli_argv with --data the packed cache of its clips."""
    argv = cli_argv(data, out, *extra)
    argv[argv.index("--data") + 1] = json.dumps(
        {"class": "txt2vid_tpu.data.packed.packed_dataset",
         "args": {"data": str(data / "clips.t2vc"), "num_frames": 4}})
    return argv


def one_process(argv):
    """The command line as one process without a group."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    proc = subprocess.run([sys.executable, *argv], cwd=str(ROOT), capture_output=True, text=True,
                          env=dict(env, OMP_NUM_THREADS="1"), timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return [proc.stdout + proc.stderr]


# name -> (world, extra flags, packed data); world 1 runs without a group
CLI_RUNS = {
    "device_one": (1, ["--device_data"], True),
    "device_fsdp": (2, ["--fsdp", "2", "--device_data"], True),
    "k2_dp": (2, ["--steps_per_dispatch", "2", "--save_model_period", "3"], False),
    "k1_dp": (2, ["--save_model_period", "3"], False),
    "k2_one": (1, ["--steps_per_dispatch", "2"], False),
    "k2_fsdp": (2, ["--fsdp", "2", "--steps_per_dispatch", "2"], False),
}


@pytest.fixture(scope="module")
def cli_runs(cli_data, tmp_path_factory):
    """Every CLI_RUNS command line, side by side: {name: (outputs, out dir
    of rank r)}."""
    from txt2vid_tpu_torch.data import packed
    packed.pack_directory(cli_data / "videos", cli_data / "clips.t2vc")
    tmp = tmp_path_factory.mktemp("cli_levers")

    def run(name):
        world, extra, is_packed = CLI_RUNS[name]
        make = packed_argv if is_packed else cli_argv
        if world == 1:
            return one_process(make(cli_data, tmp / name, *extra))
        return spawn(lambda r: [sys.executable, *make(cli_data, tmp / f"{name}{r}", *extra)],
                     world)

    with ThreadPoolExecutor(len(CLI_RUNS)) as pool:
        outs = dict(zip(CLI_RUNS, pool.map(run, CLI_RUNS)))
    yield {name: (outs[name], lambda r, name=name: tmp / (name if CLI_RUNS[name][0] == 1
                                                          else f"{name}{r}"))
           for name in CLI_RUNS}
    shutil.rmtree(tmp, ignore_errors=True)


def same_files(a, b, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def losses(text):
    return re.findall(r"Iter (\d+), Loss_D: ([\d.]+) Loss_G: ([\d.]+)", text)


def test_fsdp2_device_data_cli_equals_one_process(cli_runs):
    """--fsdp 2 --device_data (dp = 1: both ranks assemble the whole global
    batch): the whole dataset on each rank's card, rank 0's checkpoints and
    .ema byte for byte the one process's, rank 1 writes none."""
    (one_text,), one_out = cli_runs["device_one"]
    texts, out = cli_runs["device_fsdp"]
    names = checkpoints(one_out(0))
    assert len(names) == 4 and checkpoints(out(0)) == names and checkpoints(out(1)) == []
    same_files(one_out(0), out(0), names)
    per_card = re.findall(r"device dataset: 16 pairs, (\d+) bytes per card", one_text)
    assert per_card and all(re.findall(r"device dataset: 16 pairs, (\d+) bytes per card", t)
                            == per_card for t in texts)
    assert losses(one_text) == losses(texts[0]) == losses(texts[1]) and len(losses(one_text)) == 4


def jax_saves(tmp, k, chunks, period):
    """The iterations JAX's trainer saves at, k steps per chunk."""
    needs_jax_package()
    from test_torch_dispatch import _Recorder
    from txt2vid_tpu.gan import trainer as jax_trainer
    saved = []
    params = argparse.Namespace(
        out=str(tmp), out_samples=str(tmp), loss_window_size=20, log_period=5,
        save_model_period=period, save_example_period=0, save_initial=False,
        save_initial_examples=False, clip_grad=100.0, nan_abort=True, nan_abort_streak=100,
        nan_abort_window=200, nan_abort_window_count=20, g_ema=0.0, rss_limit_gb=0,
        steps_per_dispatch=k)

    class State:
        step = 0

    def step(state, chunk, key):
        return state, {m: np.ones(k, np.float32) for m in ("loss_d", "loss_g", "grad_norm_d",
                                                            "grad_norm_g")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "AsyncCheckpointer", lambda **kw: _Recorder(saved))
        mp.setattr(jax_trainer, "status", lambda *a: None)
        jax_trainer.train(gan=None, state=State(), train_step=step, num_epoch=1,
                          dataset=list(range(chunks)), params=params, base_key=0)
    return saved


def test_dp2_two_steps_per_dispatch_equal_single_steps(cli_runs, tmp_path):
    """dp=2, 4 steps as 2 chunks of 2 and as 4 single steps, save period 3:
    each run saves where JAX's trainer does (the chunk end 4; 3 and the
    final 4), the iteration-4 states are the same bytes, and every rank
    logs the same losses."""
    k2_texts, k2 = cli_runs["k2_dp"]
    k1_texts, k1 = cli_runs["k1_dp"]
    for out, k in ((k2, 2), (k1, 1)):
        saved = [int(n.split("_")[1]) for n in checkpoints(out(0)) if not n.endswith(".ema")]
        assert saved == sorted(set(jax_saves(tmp_path, k, 4 // k, 3))), (k, saved)
        assert checkpoints(out(1)) == []
    # the state (the .ema differs by design: once per chunk with decay**2)
    (name,) = [n for n in checkpoints(k2(0)) if n.startswith("iter_4_") and n[-4:] != ".ema"]
    assert name in checkpoints(k1(0))
    same_files(k1(0), k2(0), [name])
    assert losses(k2_texts[0]) == losses(k2_texts[1])
    assert losses(k1_texts[0]) == losses(k1_texts[1])
    assert [it for it, _, _ in losses(k2_texts[0])] == ["2", "4"]


def test_fsdp2_ema_once_per_chunk_equals_one_process(cli_runs):
    """--fsdp 2 --steps_per_dispatch 2 --g_ema 0.999: each rank moves its
    shards of the EMA once per chunk with decay**2; rank 0's checkpoints and
    .ema files are byte for byte those of one process."""
    _, one = cli_runs["k2_one"]
    _, fsdp = cli_runs["k2_fsdp"]
    names = checkpoints(one(0))
    assert len(names) == 4 and sum(n.endswith(".ema") for n in names) == 2
    assert checkpoints(fsdp(0)) == names and checkpoints(fsdp(1)) == []
    same_files(one(0), fsdp(0), names)
