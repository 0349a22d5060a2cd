"""Training benchmark of the port: conditional TGANv2 G+D train steps per second
on one GPU (the counterpart of the JAX package's bench.py).

    python -m txt2vid_tpu_torch.bench [--seed N] [--device cuda]

The shape and configuration are bench.py's (:50-52, 128-176): batch 40,
16-frame 64 px video, frame sizes 8/16/32/64 with the subsample pyramid, RSGAN,
Adam(2e-4, b1 0.5) for G and D, the flagship conditional generator
(`tganv2_cond.MultiScaleGen`) and discriminator (`tganv2_cond.MultiScaleDiscrim`)
and the 4-layer Bi-LSTM caption encoder (vocabulary 64) in the loop, frozen.
float32 with TF32 off for matmuls and cuDNN; one generator forward per step
(shared_gen_fwd). Parameters are random by bench.py's rule (:160-173): every
float32 parameter with at least one dimension N(0, 0.02), scalars (the
attention gammas) 0. Three warm-up steps, then a 5-step and a 25-step run,
each ended by a host fetch of loss_g; the time per step is the slope between
them. Prints one JSON line. `--profile N` then traces N more steps with
torch.profiler and prints a second line: kernel time per step, the device's
busy share of the wall time, and the operators whose kernels take the most.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.gan import losses
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.train_step import TrainConfig, adam, build_train_step
from txt2vid_tpu_torch.models import tganv2_cond
from txt2vid_tpu_torch.models.txt import Seq2Seq

METRIC = "train_steps_per_sec_per_gpu_cond_tganv2_16f_64px"
BATCH = 40
NUM_FRAMES = 16
FRAME_SIZES = (8, 16, 32, 64)
VOCAB_SIZE = 64
CAPTION_LEN = 12
WARMUP, SHORT, LONG = 3, 5, 25


@torch.no_grad()
def randomize_like_bench(module: torch.nn.Module, generator: torch.Generator):
    """bench.py's parameter rule: N(0, 0.02) for every float32 parameter with
    at least one dimension, 0 for scalars."""
    for p in module.parameters():
        if p.dim() == 0:
            p.zero_()
        else:
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


def build(seed: int = 0, batch_size: int = BATCH, device=None):
    """(TrainStep, batch) for the benchmark's model and data on `device`."""
    device = resolve_device(device)
    gen = tganv2_cond.MultiScaleGen(num_frames=NUM_FRAMES)
    disc = tganv2_cond.MultiScaleDiscrim()
    enc = Seq2Seq(vocab_size=VOCAB_SIZE)
    params = torch.Generator().manual_seed(seed + 1)
    for m in (gen, disc, enc):
        randomize_like_bench(m, params)
        m.to(device)
    gan = CondGan(gen, enc, discrims=[disc])
    cfg = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True, latent_size=256,
                      shared_gen_fwd=True)
    step = build_train_step(gan, losses.RSGANLoss(), adam(gen.parameters()),
                            adam(disc.parameters()), cfg, seed=seed)
    rng = np.random.default_rng(seed)
    size = FRAME_SIZES[-1]
    video = rng.standard_normal((batch_size, NUM_FRAMES, size, size, 3),
                                dtype=np.float32).clip(-1, 1)
    batch = {"video": torch.from_numpy(video).to(device),
             "captions": torch.from_numpy(
                 rng.integers(4, VOCAB_SIZE, (batch_size, CAPTION_LEN))).to(device),
             "lengths": torch.full((batch_size,), CAPTION_LEN)}
    return step, batch


def gpu_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(args):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    step, batch = build(args.seed, BATCH, device)
    metrics = None
    for _ in range(WARMUP):
        metrics = step(batch)
    float(metrics["loss_g"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def run(n):
        t0 = time.perf_counter()
        m = None
        for _ in range(n):
            m = step(batch)
        loss_g = float(m["loss_g"])          # the host fetch ends the run
        return time.perf_counter() - t0, loss_g

    dt_short, _ = run(SHORT)
    dt_long, loss_g = run(LONG)
    sec_per_step = (dt_long - dt_short) / (LONG - SHORT)
    cuda = device.type == "cuda"
    print(json.dumps({
        "metric": METRIC, "value": 1.0 / sec_per_step, "unit": "steps/sec/gpu",
        "ms_per_step": 1e3 * sec_per_step,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
        "dtype": "f32", "batch_size": BATCH, "num_frames": NUM_FRAMES,
        "frame_sizes": list(FRAME_SIZES), "steps": [SHORT, LONG], "warmup": WARMUP,
        "loss_g": loss_g,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "name_power_limit": gpu_power_limit() if cuda else None,
    }))
    if args.profile:
        print(json.dumps(profile(step, batch, args.profile)))


def profile(step, batch, n: int, top: int = 12) -> dict:
    """Trace n steps (the last ended by a host fetch): device time per step
    (the sum of the kernels' times), the device's busy share of the wall time,
    and the `top` operators by the device time of the kernels they launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if batch["video"].is_cuda else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            m = step(batch)
        float(m["loss_g"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {"profile_steps": n, "wall_ms_per_step": 1e3 * wall / n,
            "device_ms_per_step": device_us / 1e3 / n,
            "device_busy_share": device_us / 1e6 / wall,
            "top_ops": [{"name": e.key, "calls_per_step": e.count / n,
                         "device_ms_per_step": e.self_device_time_total / 1e3 / n}
                        for e in ops]}


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="then trace N steps with torch.profiler, print a second line")
    main(p.parse_args(argv))


if __name__ == "__main__":
    cli()
