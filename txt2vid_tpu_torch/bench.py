"""Training benchmark of the port: conditional TGANv2 G+D train steps per second
on one GPU (the counterpart of the JAX package's bench.py).

    python -m txt2vid_tpu_torch.bench [--seed N] [--device cuda]
        [--bf16] [--bf16_nu] [--bf16_params] [--shared_gen_fwd] [--profile N]

The shape and configuration are bench.py's (:50-52, 128-176): batch 40,
16-frame 64 px video, frame sizes 8/16/32/64 with the subsample pyramid, RSGAN,
Adam(2e-4, b1 0.5) for G and D, the flagship conditional generator
(`tganv2_cond.MultiScaleGen`) and discriminator (`tganv2_cond.MultiScaleDiscrim`)
and the 4-layer Bi-LSTM caption encoder (vocabulary 64) in the loop, frozen.
float32 with TF32 off for matmuls and cuDNN by default; one generator forward
per step (the port's step always runs one, so --shared_gen_fwd is a no-op,
accepted so bench.py's full bf16 stack reads the same here). The bf16 flags
mean what bench.py's switches do (:94-145): --bf16 builds G and D with dtype
bf16 and stores Adam's first moment in bf16 (BENCH_BF16),
--bf16_nu the second moment too (BENCH_NU_BF16), --bf16_params runs the step
from one bf16 parameter copy (BENCH_BF16_PARAMS). bench.py turns all of them
on by default; here the default stays float32, so the f32 records stay
comparable, and the JSON line's "dtype" names what ran (e.g. "bf16+nu+params").
Parameters are random by bench.py's rule (:160-173): every
float32 parameter with at least one dimension N(0, 0.02), scalars (the
attention gammas) 0. Three warm-up steps, then a 5-step and a 25-step run,
each ended by a host fetch of loss_g; the time per step is the slope between
them. Prints one JSON line. `--profile N` then traces N more steps with
torch.profiler and prints a second line: kernel time per step, the device's
busy share of the wall time, the operators whose kernels take the most, the
kernels themselves (their names carry their dtypes) and the operators that
take the most host time.
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
from txt2vid_tpu_torch.utils import profiling

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


def dtype_name(bf16: bool = False, bf16_nu: bool = False, bf16_params: bool = False) -> str:
    """What a configuration computes in, e.g. "f32", "bf16", "bf16+nu+params"."""
    return "+".join(["bf16" if bf16 else "f32"] + [name for name, on in (
        ("nu", bf16_nu), ("params", bf16_params)) if on])


def build(seed: int = 0, batch_size: int = BATCH, device=None, bf16: bool = False,
          bf16_nu: bool = False, bf16_params: bool = False, no_lstm: bool = False):
    """(TrainStep, batch) for the benchmark's model and data on `device`, with
    bench.py's bf16 switches; `no_lstm` swaps the generator's ConvLSTM for
    TGAN's seed generator (MultiScaleGen's no_lstm)."""
    device = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else None
    gen = tganv2_cond.MultiScaleGen(num_frames=NUM_FRAMES, no_lstm=no_lstm, dtype=dtype)
    disc = tganv2_cond.MultiScaleDiscrim(dtype=dtype)
    enc = Seq2Seq(vocab_size=VOCAB_SIZE)
    params = torch.Generator().manual_seed(seed + 1)
    for m in (gen, disc, enc):
        randomize_like_bench(m, params)
        m.to(device)
    gan = CondGan(gen, enc, discrims=[disc])
    cfg = TrainConfig(frame_sizes=FRAME_SIZES, subsample_input=True, latent_size=256,
                      shared_gen_fwd=True,
                      compute_dtype=torch.bfloat16 if bf16_params else None)
    storage = dict(mu_dtype=dtype, nu_dtype=torch.bfloat16 if bf16_nu else None)
    step = build_train_step(gan, losses.RSGANLoss(), adam(gen.parameters(), **storage),
                            adam(disc.parameters(), **storage), cfg, seed=seed)
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
    """Prints, and returns, the JSON line and (with --profile) the profile's."""
    device = resolve_device(args.device)
    step, batch = build(args.seed, BATCH, device, args.bf16, args.bf16_nu, args.bf16_params)
    sec_per_step, loss_g, peak = measure(step, batch)
    cuda = device.type == "cuda"
    line = {
        "metric": METRIC, "value": 1.0 / sec_per_step, "unit": "steps/sec/gpu",
        "ms_per_step": 1e3 * sec_per_step, "peak_memory_bytes": peak,
        "dtype": dtype_name(args.bf16, args.bf16_nu, args.bf16_params),
        "batch_size": BATCH, "num_frames": NUM_FRAMES,
        "frame_sizes": list(FRAME_SIZES), "steps": [SHORT, LONG], "warmup": WARMUP,
        "loss_g": loss_g,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
        "name_power_limit": gpu_power_limit() if cuda else None,
    }
    print(json.dumps(line))
    prof = profile(step, batch, args.profile) if args.profile else None
    if prof is not None:
        print(json.dumps(prof))
    return line, prof


def measure(step, batch):
    """The bench's timing of `step` on `batch`, with TF32 off for matmuls and
    cuDNN: (seconds per step, the last loss_g, peak device bytes after the
    warm-up or None on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    metrics = None
    for _ in range(WARMUP):
        metrics = step(batch)
    float(metrics["loss_g"])
    device = batch["video"].device
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
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return (dt_long - dt_short) / (LONG - SHORT), loss_g, peak


def profile(step, batch, n: int, top: int = 12) -> dict:
    """Trace n steps (the last ended by a host fetch): device time per step
    (the sum of the kernels' times), the device's busy share of the wall time
    (the length of the union of the kernels' intervals, so overlapping work
    counts once),
    the `top` operators by the device time of the kernels they launch, the
    `top` kernels by their own device time and the `top` operators by their
    own host time (the profiler's, which inflates it)."""
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
    # a record_function range (the optimizer's step) also shows as a device
    # event spanning its kernels: counted, it would count them twice
    events = [e for e in prof.key_averages() if not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    busy_us = sum(b - a for a, b in profiling.union(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)))
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)[:top]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {"profile_steps": n, "wall_ms_per_step": 1e3 * wall / n,
            "device_ms_per_step": device_us / 1e3 / n,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_ops": [{"name": e.key, "calls_per_step": e.count / n,
                         "device_ms_per_step": e.self_device_time_total / 1e3 / n}
                        for e in ops],
            "top_kernels": [{"name": e.key, "launches_per_step": e.count / n,
                             "device_ms_per_step": e.self_device_time_total / 1e3 / n}
                            for e in kernels],
            "top_host_ops": [{"name": e.key, "calls_per_step": e.count / n,
                              "host_ms_per_step": e.self_cpu_time_total / 1e3 / n}
                             for e in host]}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="then trace N steps with torch.profiler, print a second line")
    p.add_argument("--bf16", action="store_true",
                   help="G and D in bfloat16, Adam's first moment stored bfloat16")
    p.add_argument("--bf16_nu", action="store_true",
                   help="Adam's second moment stored bfloat16 too")
    p.add_argument("--bf16_params", action="store_true",
                   help="one bfloat16 copy of the parameters per step (compute_dtype)")
    p.add_argument("--shared_gen_fwd", action="store_true",
                   help="a no-op, accepted as bench.py's flag: the port's step "
                        "always runs one generator forward")
    return p


def cli(argv=None):
    return main(build_parser().parse_args(argv))


if __name__ == "__main__":
    cli()
