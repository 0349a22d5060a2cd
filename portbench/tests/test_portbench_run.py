"""Runs of tiny cells on the CPU, through the harness's own path (the chip
check skipped): a sound run comes out correct; each fault the cells can
have, planted in the timed path, and the control (the reference in a lower
precision put in the program's place) come out not correct."""

import subprocess
import sys

import pytest
import torch

from portbench import correct, run
from portbench.drivers import serve, train
from portbench.manifest import Manifest
from portbench.tests import tiny
from portbench.tests.fixture import TRAFFIC, make_checkout

# limits for the tiny configuration on the CPU, from its readings on five
# seeds: sound runs read loss 2e-6 to 1e-4, first loss 0, grad 2e-6 to 7e-6,
# median grad 0, change 2e-4 to 5.2e-3 (median leaf 2.5e-4), videos 5e-5 / 2e-4 levels; the TF32
# control first loss 1.4e-4 and up, grad 4.6e-2 and up; half the batch grad
# 0.8 and up; videos under the controls 8e-2 levels and up
LIMITS = {"train": {"loss_gap": 0.003, "first_loss_gap": 1e-4, "grad_gap": 0.01,
                    "grad_median_gap": 1e-4, "change_gap": 0.02, "change_median_gap": 0.01,
                    "batch_rows_wrong": 0.0},
          "serve": {"video_gap": 0.01, "worst_video_gap": 0.02,
                    "sampled_requests_unfinished": 0.0}}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("checkout"), LIMITS)


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-serve"])
def test_sound_run_is_correct(checkout, cell):
    line, rows = run.execute(Manifest(checkout), cell, 2 ** 31 + 12345, 1.0, 0, "cpu")
    assert line["correct"], rows
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) >= {"setup_s", "peak_mem_gib"}
    assert line["attempted"] > 0


@pytest.mark.parametrize("cell,names", [
    ("tiny-train", {"data_wait_ms.train_f32", "train_mfu.f32", "gp_step_ms"}),
    ("tiny-serve", {"serve_service_ms", "serve_mfu"})])
def test_traced_run_reports_layers(checkout, cell, names):
    line, _ = run.execute(Manifest(checkout), cell, 5, 1.0, 1, "cpu")
    assert names <= set(line["metrics"])
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert "breakdown" in line


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(fault):
    out = train.run(tiny.spec(), TRAFFIC["tiny_loader"], 7, 0.0, False, "cpu", fault=fault,
                    window=False)
    ok, rows = correct.judge(out["checks"], LIMITS["train"])
    assert not ok, rows


def test_altered_answer_is_caught():
    out = serve.run(tiny.spec(), TRAFFIC["tiny_poisson"], 7, 0.0, False, "cpu",
                    fault="altered", window=False)
    ok, rows = correct.judge(out["checks"], LIMITS["serve"])
    assert not ok, rows


@pytest.mark.parametrize("driver,traffic,name", [
    (train, "tiny_loader", "tf32"), (serve, "tiny_poisson", "fp8")])
def test_control_is_not_correct(driver, traffic, name):
    out = driver.run(tiny.spec(), TRAFFIC[traffic], 8, 0.0, False, "cpu", control=name,
                     window=False)
    kind = "train" if driver is train else "serve"
    assert correct.judge(out["checks"], LIMITS[kind])[0]
    ok, rows = correct.judge(out["control_checks"], LIMITS[kind])
    assert not ok, rows


def test_no_cuda_no_result(checkout):
    """Without a card the command exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "cond128-f32-train", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=run.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_run_loads_no_jax(tmp_path):
    """A run's process holds none of jax, jaxlib, flax or the JAX package."""
    root = make_checkout(tmp_path, LIMITS)
    code = ("import sys, torch; torch.set_num_threads(2); from portbench import run; "
            "from portbench.manifest import Manifest; "
            f"run.execute(Manifest({str(root)!r}), 'tiny-serve', 3, 0.5, 0, 'cpu'); "
            "print(run.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=run.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
