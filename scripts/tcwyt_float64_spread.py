"""Where the spread of chip_smoke.py's TCWYT float64 rule comes from, on one
NVIDIA GPU.

    python scripts/tcwyt_float64_spread.py [--seed 0] [--states 2]

Phase families' rule takes scripts/run.sh's TCWYT state after 4 CLI steps
and 2 resumed ones, and holds one float32 step on the card against the
float64 step of the same state and draws (chip_smoke.Float64Step). Both the
trained state and the card's float32 step may vary with cuDNN's
non-deterministic algorithms. This script trains `--states` states with
cuDNN free and as many with cuDNN deterministic, and prints per state:
- a hash of its checkpoint (equal hashes: the training is reproducible);
- the card's float32 distance from float64, twice with cuDNN deterministic
  and twice free (the step's own spread);
- the same float32 step on the host's CPU at chip_smoke.F64_CPU_THREADS;
- the controls: one sample's z drawn anew, and one G leaf's first moment
  moved by 1% of its leaf scale before the step.
The first deterministic training runs under
torch.use_deterministic_algorithms(True, warn_only=True) and prints every
operation that has no deterministic implementation. The last line is a
JSON object of every reading.
"""

import argparse
import contextlib
import hashlib
import json
import shutil
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from txt2vid_tpu_torch.utils import checkpoint  # noqa: E402


def train_state(root, seed, deterministic, audit=False):
    """scripts/run.sh's TCWYT: 4 CLI steps and 2 resumed; (step, batch,
    sha256 of the last checkpoint, non-deterministic operations seen)."""
    shutil.rmtree(root / "tcwyt", ignore_errors=True)
    seen = set()
    with contextlib.ExitStack() as stack:
        if deterministic:
            stack.enter_context(cs.deterministic_cudnn())
        if audit:
            torch.use_deterministic_algorithms(True, warn_only=True)
            caught = stack.enter_context(warnings.catch_warnings(record=True))
            warnings.simplefilter("always")
        cs.family_cli("tcwyt", cs.run_sh_argv(root, seed, "--epochs", str(cs.RUN_SH_EPOCHS)))
        resumed, _, _, _ = cs.family_cli("tcwyt --resume",
                                         cs.run_sh_argv(root, seed, "--epochs", "1", "--resume"))
        if audit:
            torch.use_deterministic_algorithms(False)
            seen = {str(w.message).split("\n")[0][:200] for w in caught
                    if "deterministic" in str(w.message)}
    latest = checkpoint.latest_checkpoint(root / "tcwyt")
    digest = hashlib.sha256(Path(latest).read_bytes()).hexdigest()[:16]
    return resumed.step, resumed.batch, digest, sorted(seen)


def moment_control(rule, mom64):
    """The card's float32 step after moving the first moment of G's largest
    leaf by 1% of its leaf scale: its distance from float64."""
    step = rule.step
    name, p = max(step.gan.gen.named_parameters(), key=lambda kv: kv[1].numel())
    saved = rule.start.opts[0][p]["exp_avg"]
    scale = cs.leaf_scales(mom64["G"])[name]
    rule.start.opts[0][p]["exp_avg"] = saved + 0.01 * scale
    try:
        _, mom = rule.run(torch.float32)
    finally:
        rule.start.opts[0][p]["exp_avg"] = saved
    return rule.distance(mom, mom64), name


def readings(step, batch, cpu=True):
    rule = cs.Float64Step(step, batch)
    out = {}
    with cs.deterministic_cudnn():
        _, mom64 = rule.run(torch.float64)
        out["card_det"] = [rule.distance(rule.run(torch.float32)[1], mom64) for _ in range(2)]
        out["control_z"] = rule.distance(rule.run(torch.float32, draws=rule.control_draws())[1],
                                         mom64)
        out["control_moment"], out["control_moment_leaf"] = moment_control(rule, mom64)
    out["card_free"] = [rule.distance(rule.run(torch.float32)[1], mom64) for _ in range(2)]
    if cpu:
        out["cpu"] = {}
        for threads in cs.F64_CPU_THREADS:
            t0 = time.perf_counter()
            out["cpu"][threads] = rule.distance(
                rule.run(torch.float32, "cpu", threads=threads)[1], mom64)
            out["cpu"][threads] += (round(time.perf_counter() - t0, 2),)
    rule.restore()
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--states", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device: this script runs on the GPU")
    _, smi = cs.phase_device()
    root = cs.smoke_dir("tcwyt_spread_")
    results = []
    try:
        cs.families_data(root, args.seed)
        for k, deterministic in enumerate([False] * args.states + [True] * args.states):
            t0 = time.perf_counter()
            audit = deterministic and not any(r["deterministic"] for r in results)
            step, batch, digest, ops = train_state(root, args.seed, deterministic, audit)
            r = {"deterministic": deterministic, "checkpoint_sha256": digest,
                 "train_s": round(time.perf_counter() - t0, 2)}
            if audit:
                r["nondeterministic_ops"] = ops
            r.update(readings(step, batch))
            print(f"state {k}: {json.dumps(r)}", flush=True)
            results.append(r)
            del step, batch
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi)
    print(json.dumps({"states": results}))


if __name__ == "__main__":
    main()
