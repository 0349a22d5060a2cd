"""Drive txt2vid_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN, so
   the port's float32 runs in float32.
2. build: every CUDA kernel of the port, from txt2vid_tpu_torch/csrc, with nvcc
   (registers, shared memory and spills as ptxas reports them), and the count
   of tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma) in each
   kernel's SASS, read with cuobjdump. Fails if K1, K2 or K3 has none.
3. kernels: each kernel (K1 the attention forward, K2 and K3 its backward)
   against its plain PyTorch version on the card, at the main paths' shapes,
   the parity shapes of tpu_checks.py and ragged shapes, in float32 and
   bfloat16; K2 and K3 run twice at REPEAT_SHAPES must agree bit for bit.
   Then each kernel's time beside the plain version's and one PyTorch library
   call's that computes the same function (per call, and per call in a CUDA
   graph where it captures), its bounds and the resident warps per SM, at
   the serving and training shapes and at the discriminator's four
   training shapes (D_TRAIN_SHAPES, nested under "d_shapes"). K1's record
   keeps the serving shape and the serve phase's launches; its training shape
   is nested under "train_shape". K2 and K3 records hold the training shape.
4. serve: the caption->video service (txt2vid_tpu_torch.serve) at the width of
   the flagship conditional model, weights random from --seed and every
   attention gamma set to 1, answering 20 captions of mixed length in chunks of
   8. Launch counts are zeroed just before and read just after; the same
   requests with every kernel replaced by its plain version must agree.
5. train: the conditional TGANv2 train step of txt2vid_tpu_torch.bench (batch
   40, 16 frames, frame sizes 8/16/32/64, the flagship G and D at full width,
   the caption encoder in the loop), parameters random from --seed by the
   bench's rule and every attention gamma set to 1. One step from a copied
   state with the kernels and one under no_kernel() must agree; then 3 steps
   with the launch counts zeroed just before, each launching K1 17 times and
   K2 and K3 13 times, with finite losses; every G and D parameter with a
   nonzero gradient must have moved, the attention blocks' among them.
6. cli: the training CLI as users run it. 80 synthetic clips (16x64x64x3)
   and a vocabulary written by the port's own generator to a directory under
   build/ (removed at the end), then `txt2vid_tpu_torch.train.gan.main`
   in-process at scripts/run_tganv2_cond.sh's configuration (the flagship G
   and D at full width, Seq2Seq, frame sizes 8/16/32/64 with the subsample
   pyramid, RSGAN, Adam 2e-4 (0.5, 0.999), batch 40) plus --gp_lambda 0.5
   --gp_every 2 --clip_grad 100 --g_ema 0.999, for 3 epochs of 2 batches
   (6 steps, the GP on steps 0, 2 and 4) with --save_model_period 4
   --log_period 1 --save_example_period 4 --sample_batch_size 8. Every step
   must have finite losses and norms and launch K1 17 and K2, K3 13 times,
   GP steps included (the GP's double backward takes the plain attention).
   The checkpoint of iteration 6 must read back bit for bit against the
   state in memory (parameters, BatchNorm statistics, both optimizers'
   moments and counts) and its `.ema` sibling against the average in
   memory; `--resume --epochs 1` must continue at iteration 7 and end at 8.
   From the resumed state (a GP step), every attention gamma set to 1, one
   step with the kernels and one under no_kernel() must agree: losses 1e-4
   relative, Adam first moments 1e-3 of the leaf scale, or, where the plain
   float32 step itself strays from a float64 step of the same state (a
   trained state's attention projections), the kernels' step no further
   from the float64 step than 3x the plain one. Then 8 steps of that TrainStep alone (GP and
   plain alternating). Prints each step's ms (host clock, synchronized; the
   medians of GP and plain steps from the 8 alone), the peak memory, the
   checkpoint's bytes and the seconds of a synchronous save, and the EMA
   update's ms.

With --baseline DIR (another checkout's root, e.g. the parent commit's
`git archive` unpacked under build/), a phase compare after the kernels phase
times that checkout's K1, K2 and K3, built from its own sources, beside this
one's at the same shapes, in the order baseline, this, this, baseline.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import argparse
import importlib.util
import json
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from txt2vid_tpu_torch import bench
from txt2vid_tpu_torch.convert import jax_state_to_torch, torch_state_to_jax
from txt2vid_tpu_torch.data import build_vocab, load_pickle
from txt2vid_tpu_torch.data.synthetic import generate_examples, moving_digit_captions
from txt2vid_tpu_torch.gan import ema as ema_mod
from txt2vid_tpu_torch.gan.train_step import TrainStep
from txt2vid_tpu_torch.models import layers as layers_mod
from txt2vid_tpu_torch.models.layers import Attention, Attention3d
from txt2vid_tpu_torch.ops import _build
from txt2vid_tpu_torch.ops.attention import no_kernel
from txt2vid_tpu_torch.ops.fused_attention import (
    attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq,
    attention_bwd_dq_reference, attention_delta, fused_attention,
    fused_attention_reference, occupancy)
from txt2vid_tpu_torch.serve import GeneratorService
from txt2vid_tpu_torch.train import gan as train_gan
from txt2vid_tpu_torch.utils import checkpoint

# NVIDIA H100 SXM data sheet: HBM bandwidth, float32 outside the tensor cores,
# and TF32 on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12

# (B, N, M, d, dv): the generator's up1 attention serving batch 8 (128 frames
# of 32x32) and training batch 40 (after two subsamples, 40 frames of 32x32),
# the discriminator's Attention3d at the training pyramid's four scales, the
# parity shapes of tpu_checks.py, and shapes no tile divides (the last, with
# 3 chunks of 16 keys, is where K2 splits a query tile's keys 2 ways)
SERVE_SHAPE = (128, 1024, 256, 4, 16)
TRAIN_SHAPE = (40, 1024, 256, 4, 16)
D_TRAIN_SHAPES = [(40, 16, 4, 16, 64), (20, 32, 8, 16, 64), (10, 64, 16, 16, 64),
                  (5, 256, 64, 16, 64)]
ATTENTION_SHAPES = [SERVE_SHAPE, TRAIN_SHAPE, *D_TRAIN_SHAPES, (2, 1024, 256, 16, 64),
                    (4, 4096, 1024, 16, 64), (2, 1024, 256, 4, 16), (1, 64, 16, 16, 64),
                    (3, 1000, 250, 4, 16), (2, 45, 15, 16, 64), (2, 100, 40, 16, 64)]
# K2 and K3 run twice on the same inputs must agree bit for bit here: the
# generator's shape and the discriminator's largest (K2 splits its keys 4 ways)
REPEAT_SHAPES = [TRAIN_SHAPE, (5, 256, 64, 16, 64)]
# float32: max|diff| <= 1e-4 * max(1, max|ref|), summation order only. bfloat16:
# the same bf16 inputs through the plain f32 version; the kernel rounds o to
# bf16 (8 bits of mantissa, 4e-3 relative), so o takes 1e-2, lse (f32) 1e-4.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}
# backward: float32 1e-4 * scale (summation order); bfloat16 1e-2 * scale, the
# kernel rounding its f32 result to bf16 once
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NUM_CAPTIONS, BATCH = 20, 8
# launches per train step, counted from the code: K1 1 (generator) + 8 (D
# phase: real_cc and fake_cc at 4 scales; real_ic reuses real_cc's features)
# + 4 (the updated D's real predictions) + 4 (the G phase's fake pass); K2 and
# K3 8 (the D backward) + 4 (through D to the fakes) + 1 (generator)
TRAIN_LAUNCHES = {"attention_fwd": 17, "attention_bwd_dq": 13, "attention_bwd_dkv": 13}
TRAIN_STEPS = 3
KERNELS = {"attention_fwd": fused_attention, "attention_bwd_dq": attention_bwd_dq,
           "attention_bwd_dkv": attention_bwd_dkv}
BWD_OUTPUTS = {"attention_bwd_dq": ("dtheta",), "attention_bwd_dkv": ("dphi", "dg")}
# kernels that must show tensor-core instructions in their SASS
TENSOR_CORE_KERNELS = ("attention_fwd", "attention_bwd_dq", "attention_bwd_dkv")
# multiply-adds per (query, key) pair: K1 theta.phi and p.g; K2 theta.phi,
# do.g and ds.phi; K3 theta.phi, do.g, p.do and ds.theta
PAIR_MACS = {"attention_fwd": lambda d, dv: d + dv,
             "attention_bwd_dq": lambda d, dv: 2 * d + dv,
             "attention_bwd_dkv": lambda d, dv: 2 * d + 2 * dv}


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def max_err(ref, got):
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max()), max(1.0, float(ref.abs().max()))


def cuda_ms(fn, reps=25, warmup=3):
    """Median ms of one call, each timed alone with CUDA events. At the
    discriminator's shapes this is mostly the host's launch time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches=20, reps=10, stream=None):
    """Median device ms of one call, from a CUDA graph of `launches` calls
    (warmed up and captured on `stream`, default a new one) replayed `reps`
    times: no host time between launches."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def library_graph_ms(fn, what, stream=None):
    """graph_ms of a library call, or None, printed, where it does not
    capture in a CUDA graph."""
    try:
        return graph_ms(fn, stream=stream)
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"phase kernels: {what} does not capture in a CUDA graph: "
              f"{str(e).strip().splitlines()[0]}")
        return None


def attention_inputs(shape, dtype, seed):
    b, n, m, d, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(size, generator=gen, device="cuda").to(dtype)
            for size in ((b, n, d), (b, m, d), (b, m, dv))]


def bounds(shape, dtype, kernel):
    """The least time for `kernel` at `shape`: theta, phi, g (and for the
    backward do in the input dtype, lse and delta in f32) read once and the
    outputs written once over HBM bandwidth, or its 2*B*N*M*PAIR_MACS
    operations over a peak rate, whichever is larger (exponentials not
    counted). Returns {bound_ms, bound_by} against the f32 rate outside the
    tensor cores, as earlier records hold, and {tc_bound_ms, tc_bound_by}
    against three TF32 passes on the tensor cores, the float32 design of the
    kernels."""
    b, n, m, d, dv = shape
    isz = torch.finfo(dtype).bits // 8
    nbytes = isz * (b * n * d + b * m * d + b * m * dv)
    if kernel == "attention_fwd":
        nbytes += isz * b * n * dv
    else:
        nbytes += isz * b * n * dv + 4 * 2 * b * n
        nbytes += isz * (b * n * d if kernel == "attention_bwd_dq" else b * m * (d + dv))
    flops = 2 * b * n * m * PAIR_MACS[kernel](d, dv)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {}
    for key, t_ops in (("", flops / PEAK_F32_FLOP_PER_S),
                       ("tc_", 3 * flops / PEAK_TF32_FLOP_PER_S)):
        out[f"{key}bound_ms"] = 1e3 * max(t_bytes, t_ops)
        out[f"{key}bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def zero_counts():
    for k in KERNELS.values():
        k.launches = 0


def counts():
    return {name: k.launches for name, k in KERNELS.items()}


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"phase device: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    """Builds the kernels; returns each kernel's tensor-core instruction
    counts in its SASS, summed over its instantiations."""
    seconds = _build.build_all()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase build: {name}: {line.strip()}")
    print(f"phase build: {sorted(_build.SOURCES)} built in {seconds:.2f} s")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    tc = {name: {"HMMA": 0, "HGMMA": 0} for name in KERNELS}
    for lib in _build.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function : " in line:
                kernel = next((k for k in KERNELS if f"{k}_kernel" in line), None)
            elif kernel is not None:
                for op in tc[kernel]:
                    tc[kernel][op] += len(re.findall(rf"\b{op}\b", line))
    for name, counts in tc.items():
        print(f"phase build: {name} SASS tensor-core instructions {counts}")
    check(all(sum(tc[k].values()) > 0 for k in TENSOR_CORE_KERNELS),
          f"no tensor-core instruction in the SASS of {TENSOR_CORE_KERNELS}: {tc}")
    return tc


def phase_attention(seed):
    """K1 against its plain version at every shape and dtype; times at the
    serving, the training and the discriminator's shapes. Returns the
    kernel's record for the JSON line (the serving shape's numbers, the
    others nested)."""
    serve_err = train_err = None
    for shape in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            theta, phi, g = attention_inputs(shape, dtype, seed)
            o, lse = fused_attention(theta, phi, g, return_lse=True)
            torch.cuda.synchronize()
            ref_o, ref_lse = fused_attention_reference(theta, phi, g, return_lse=True)
            torch.cuda.synchronize()
            check(o.dtype == dtype and o.shape == ref_o.shape and lse.shape == shape[:2],
                  f"attention {shape} {dtype}: output {o.dtype} {tuple(o.shape)}")
            tol_o, tol_lse = TOL[dtype]
            err_o, scale_o = max_err(ref_o, o)
            err_l, scale_l = max_err(ref_lse, lse)
            ok = err_o <= tol_o * scale_o and err_l <= tol_lse * scale_l
            print(f"phase kernels: attention_fwd {shape} {str(dtype)[6:]}: "
                  f"o err {err_o:.3g} (tol {tol_o * scale_o:.3g}), "
                  f"lse err {err_l:.3g} (tol {tol_lse * scale_l:.3g}) "
                  f"{'ok' if ok else 'DISAGREES'}")
            check(ok, f"attention_fwd disagrees with its plain version at {shape} {dtype}")
            if shape == SERVE_SHAPE and dtype == torch.float32:
                serve_err = err_o
            if shape == TRAIN_SHAPE and dtype == torch.float32:
                train_err = err_o

    record = time_forward(SERVE_SHAPE, seed)
    record["max_abs_err"] = serve_err
    train = time_forward(TRAIN_SHAPE, seed)
    train["max_abs_err"] = train_err
    return {"name": "attention_fwd", "route": "cuda",
            "source": "txt2vid_tpu_torch/csrc/attention_fwd.cu",
            "replaces": "txt2vid_tpu/ops/pallas_attention.py:43",
            "launches": None, **record, "train_shape": train,
            "d_shapes": [time_forward(shape, seed) for shape in D_TRAIN_SHAPES]}


def time_forward(shape, seed):
    """K1's float32 time at `shape` beside its plain version's, SDPA's and its
    bounds, and the warps per SM it keeps resident."""
    theta, phi, g = attention_inputs(shape, torch.float32, seed)
    ms = cuda_ms(lambda: fused_attention(theta, phi, g))
    device_ms = graph_ms(lambda: fused_attention(theta, phi, g))
    plain_ms = cuda_ms(lambda: fused_attention_reference(theta, phi, g))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(theta, phi, g, scale=1.0)
    sdpa_err, _ = max_err(fused_attention_reference(theta, phi, g), sdpa())
    library_ms = cuda_ms(sdpa)
    library_device_ms = library_graph_ms(sdpa, "scaled_dot_product_attention")
    bound = bounds(shape, torch.float32, "attention_fwd")
    occ = occupancy("attention_fwd", shape)
    print(f"phase kernels: attention_fwd at {shape} float32: kernel {ms:.4f} ms "
          f"(in a CUDA graph {device_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms (in a CUDA graph "
          f"{library_device_ms}; its max|diff| {sdpa_err:.3g}), "
          f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, tensor-core bound "
          f"{bound['tc_bound_ms']:.4f} ms by {bound['tc_bound_by']}, {occ}")
    return {"ms": ms, "graph_ms": device_ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms, "library_graph_ms": library_device_ms,
            "resident_warps_per_sm": occ["resident_warps_per_sm"],
            "shape": list(shape), "dtype": "float32"}


def bwd_inputs(shape, dtype, seed):
    """(theta, phi, g, do, lse, delta): forward inputs, lse from K1, a random
    output gradient and delta = rowsum(do * o)."""
    theta, phi, g = attention_inputs(shape, dtype, seed)
    o, lse = fused_attention(theta, phi, g, return_lse=True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    return theta, phi, g, do, lse, attention_delta(o, do)


def phase_attention_bwd(seed):
    """K2 and K3 against their plain versions at every shape and dtype, K3's
    repeatability; times at the generator's training shape (the records) and
    the discriminator's shapes (nested). Returns their records."""
    train_err = {}
    for shape in ATTENTION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = bwd_inputs(shape, dtype, seed)
            dtheta = attention_bwd_dq(*args)
            dphi, dg = attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            ref_dphi, ref_dg = attention_bwd_dkv_reference(*args)
            pairs = {"dtheta": (attention_bwd_dq_reference(*args), dtheta),
                     "dphi": (ref_dphi, dphi), "dg": (ref_dg, dg)}
            errs = {}
            for what, (ref, got) in pairs.items():
                check(got.dtype == dtype and got.shape == ref.shape,
                      f"{what} {shape} {dtype}: {got.dtype} {tuple(got.shape)}")
                errs[what] = max_err(ref, got)
            ok = all(e <= BWD_TOL[dtype] * sc for e, sc in errs.values())
            print(f"phase kernels: attention_bwd {shape} {str(dtype)[6:]}: " + ", ".join(
                f"{w} err {e:.3g} (tol {BWD_TOL[dtype] * sc:.3g})" for w, (e, sc) in errs.items())
                + f" {'ok' if ok else 'DISAGREES'}")
            check(ok, f"attention_bwd disagrees with its plain version at {shape} {dtype}")
            if shape == TRAIN_SHAPE and dtype == torch.float32:
                train_err = {w: e for w, (e, _) in errs.items()}

    for shape in REPEAT_SHAPES:
        args = bwd_inputs(shape, torch.float32, seed)
        for name, kernel in (("attention_bwd_dq", attention_bwd_dq),
                             ("attention_bwd_dkv", attention_bwd_dkv)):
            first, again = kernel(*args), kernel(*args)
            torch.cuda.synchronize()
            first, again = ((x,) if torch.is_tensor(x) else x for x in (first, again))
            check(all(torch.equal(x, y) for x, y in zip(first, again)),
                  f"{name} is not repeatable bit for bit at {shape}")
            print(f"phase kernels: {name} at {shape} float32 repeats bit for bit")

    records = time_backward(TRAIN_SHAPE, seed)
    per_shape = [time_backward(shape, seed) for shape in D_TRAIN_SHAPES]
    for i, r in enumerate(records):
        r["max_abs_err"] = max(train_err[w] for w in BWD_OUTPUTS[r["name"]])
        r["d_shapes"] = [rs[i] for rs in per_shape]
    return records


def time_backward(shape, seed):
    """K2's and K3's float32 times at `shape` beside their plain versions',
    the SDPA backward's (dtheta, dphi and dg together), their bounds and the
    warps per SM they keep resident."""
    args = bwd_inputs(shape, torch.float32, seed)
    theta, phi, g, do = args[:4]
    q, k, v = (t.detach().requires_grad_() for t in (theta, phi, g))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0)
    o_lib = sdpa()
    library = lambda: torch.autograd.grad(o_lib, (q, k, v), do, retain_graph=True)
    lib_err = max(max_err(r, l)[0] for r, l in zip(
        (attention_bwd_dq_reference(*args), *attention_bwd_dkv_reference(*args)), library()))
    library_ms = cuda_ms(library)
    # a backward's ops run on its forward's stream: for a graph, the forward
    # (and its leaves' nodes) on the stream the graph captures on
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().requires_grad_() for t in (theta, phi, g)]
        o_side = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=1.0)
    library_device_ms = library_graph_ms(
        lambda: torch.autograd.grad(o_side, leaves, do, retain_graph=True),
        "scaled_dot_product_attention backward", stream=side)
    records = []
    for name, kernel, plain in (
            ("attention_bwd_dq", attention_bwd_dq, attention_bwd_dq_reference),
            ("attention_bwd_dkv", attention_bwd_dkv, attention_bwd_dkv_reference)):
        ms = cuda_ms(lambda: kernel(*args))
        device_ms = graph_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        bound = bounds(shape, torch.float32, name)
        warps = occupancy(name, shape)["resident_warps_per_sm"]
        print(f"phase kernels: {name} at {shape} float32: kernel {ms:.4f} ms (in a CUDA "
              f"graph {device_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} "
              f"ms by {bound['bound_by']}, tensor-core bound {bound['tc_bound_ms']:.4f} ms, "
              f"{warps:.2f} resident warps per SM")
        records.append({
            "name": name, "route": "cuda", "source": "txt2vid_tpu_torch/csrc/attention_bwd.cu",
            "replaces": ("txt2vid_tpu/ops/pallas_attention.py:141" if name == "attention_bwd_dq"
                         else "txt2vid_tpu/ops/pallas_attention.py:171"),
            "launches": None, "ms": ms, "graph_ms": device_ms,
            "plain_ms": plain_ms, **bound, "library_ms": library_ms,
            "library_graph_ms": library_device_ms,
            "library_computes": "dtheta, dphi and dg together",
            "resident_warps_per_sm": warps, "shape": list(shape), "dtype": "float32"})
    print(f"phase kernels: scaled_dot_product_attention backward (dtheta, dphi, dg) at "
          f"{shape} float32: {library_ms:.4f} ms (in a CUDA graph {library_device_ms}; its "
          f"max|diff| {lib_err:.3g}); K2 + K3 {records[0]['ms'] + records[1]['ms']:.4f} ms "
          f"(in a CUDA graph {records[0]['graph_ms'] + records[1]['graph_ms']:.4f})")
    return records


def load_baseline(root):
    """ops/fused_attention.py of the checkout at `root`, with its own _build:
    its kernels come from its own csrc/ and build into its own build/."""
    ops = Path(root).resolve() / "txt2vid_tpu_torch" / "ops"
    mods = {}
    for name in ("_build", "fused_attention"):
        spec = importlib.util.spec_from_file_location(f"baseline_{name}", ops / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mods["fused_attention"]._build = mods["_build"]
    return mods["fused_attention"]


def phase_compare(root, seed):
    """K1, K2 and K3 of the checkout at `root` and of this one, float32, timed
    in turns on the same inputs, each checked against this one's plain
    version."""
    base = load_baseline(root)
    print(f"phase compare: baseline {root} built in {base._build.build_all():.2f} s")
    this = sys.modules[fused_attention.__module__]
    for name, plain_fn, shapes in (
            ("fused_attention", fused_attention_reference,
             [SERVE_SHAPE, TRAIN_SHAPE, *D_TRAIN_SHAPES]),
            ("attention_bwd_dq", attention_bwd_dq_reference, [TRAIN_SHAPE, *D_TRAIN_SHAPES]),
            ("attention_bwd_dkv", attention_bwd_dkv_reference, [TRAIN_SHAPE, *D_TRAIN_SHAPES])):
        for shape in shapes:
            args = (attention_inputs(shape, torch.float32, seed) if name == "fused_attention"
                    else bwd_inputs(shape, torch.float32, seed))
            plain = plain_fn(*args)
            times = {"baseline": [], "this": []}
            for tag, mod in (("baseline", base), ("this", this), ("this", this),
                             ("baseline", base)):
                fn = lambda: getattr(mod, name)(*args)
                got = fn()
                err = max(max_err(r, x)[0] for r, x in
                          zip(plain if isinstance(plain, tuple) else (plain,),
                              got if isinstance(got, tuple) else (got,)))
                times[tag].append((cuda_ms(fn), graph_ms(fn), err))
            print(f"phase compare: {name} at {shape} float32, (ms, ms in a CUDA graph, "
                  f"max|diff| from plain) in the order baseline, this, this, baseline: "
                  f"{times['baseline'][0]} {times['this'][0]} {times['this'][1]} "
                  f"{times['baseline'][1]}")


def mixed_captions(n, seed):
    """Synthetic moving-digit captions cut to 2..6 words, so lengths differ."""
    out = []
    for i, c in enumerate(moving_digit_captions(n, seed)):
        words = c.rstrip(".").split()
        out.append(" ".join(words[:2 + i % 5]) + ".")
    return out


def phase_serve(seed):
    """The flagship service on the card. Returns (launches, ms per video)."""
    vocab = build_vocab(moving_digit_captions(1000, seed))
    svc = GeneratorService.from_seed(vocab, seed=seed, batch_size=BATCH, device="cuda")
    attns = [m for m in svc.gan.gen.modules() if isinstance(m, Attention)]
    check(len(attns) == 1, f"flagship generator has {len(attns)} Attention blocks")
    with torch.no_grad():
        for m in attns:
            m.gamma.fill_(1.0)
    captions = mixed_captions(NUM_CAPTIONS, seed)
    n, chunks = svc._chunks(captions)
    lengths = sorted(set(svc._tokenize(captions)[1].tolist()))
    print(f"phase serve: {n} captions in {len(chunks)} chunks of {BATCH}, "
          f"token lengths {lengths}")
    check(len(lengths) > 1, "caption lengths are not mixed")

    svc.generate(sentences=captions, seed=seed + 1)           # warm-up: cuDNN, kernel load
    torch.cuda.synchronize()
    fused_attention.launches = 0
    t0 = time.perf_counter()
    out = svc.generate(sentences=captions, seed=seed)         # ends in the copy to the host
    dt = time.perf_counter() - t0
    launches = fused_attention.launches

    check(out.dtype.name == "uint8" and out.shape == (NUM_CAPTIONS, 16, 64, 64, 3),
          f"service returned {out.dtype} {out.shape}")
    check(launches == len(chunks),
          f"attention_fwd launched {launches} times for {len(chunks)} chunks")
    check(float(out.std()) > 1.0, "the video is constant")

    worst = 0.0
    for i, (toks, lens) in enumerate(chunks):
        z = svc._draw_z(seed, i)
        video = svc._video(toks, lens, z)
        with no_kernel():
            plain = svc._video(toks, lens, z)
        check(bool(torch.isfinite(video).all()), f"chunk {i}: non-finite video")
        worst = max(worst, float((video - plain).abs().max()))
    with no_kernel():
        plain_u8 = svc.generate(sentences=captions, seed=seed)
    u8_diff = int(abs(out.astype(int) - plain_u8.astype(int)).max())
    print(f"phase serve: kernel vs plain attention: float max|diff| {worst:.3g} "
          f"(tol 1e-4), uint8 max|diff| {u8_diff} (tol 1)")
    check(worst <= 1e-4 and u8_diff <= 1, "the service disagrees with its plain version")
    ms_per_video = 1e3 * dt / NUM_CAPTIONS
    print(f"phase serve: uint8 {out.shape}, attention_fwd launches {launches}, "
          f"{ms_per_video:.3f} ms/video, {NUM_CAPTIONS / dt:.3f} videos/s")
    return launches, ms_per_video


def leaf_scales(moments):
    """name -> max|leaf|, floored at 1e-2 * the phase's largest: a gradient
    that is zero in exact arithmetic (a conv bias before a BatchNorm) holds
    float noise that differs between any two runs."""
    top = max(float(v.abs().max()) for v in moments.values())
    return {k: max(float(v.abs().max()), 1e-2 * top) for k, v in moments.items()}


def phase_train(seed):
    """The bench's train step on the card. Returns the launch counts of its
    TRAIN_STEPS steps."""
    step, batch = bench.build(seed, bench.BATCH, "cuda")
    gan = step.gan
    modules = {"G": gan.gen, "D": gan.discrims[0]}
    opts = {"G": step.opt_g, "D": step.opt_d}
    attns = [m for mod in modules.values() for m in mod.modules()
             if isinstance(m, (Attention, Attention3d))]
    check(len(attns) == 2, f"{len(attns)} attention blocks in G and D")
    with torch.no_grad():
        for m in attns:
            m.gamma.fill_(1.0)
    start = {k: {n: t.clone() for n, t in m.state_dict().items()}
             for k, m in modules.items()}

    def restore():
        for k, m in modules.items():
            m.load_state_dict(start[k])
            opts[k].state.clear()
        step.step = 0

    def moments():
        return {k: {n: opts[k].state[p]["exp_avg"].clone()
                    for n, p in modules[k].named_parameters()} for k in modules}

    draws = step.draw(bench.BATCH, "cuda")
    m_kernel = {k: float(v) for k, v in step(batch, draws).items()}
    mom_kernel = moments()
    restore()
    with no_kernel():
        m_plain = {k: float(v) for k, v in step(batch, draws).items()}
    mom_plain = moments()
    restore()
    loss_err = max(abs(m_kernel[k] - m_plain[k]) / abs(m_plain[k])
                   for k in ("loss_d", "loss_g"))
    worst = 0.0
    for side in modules:
        scales = leaf_scales(mom_plain[side])
        for n, ref in mom_plain[side].items():
            worst = max(worst, float((ref - mom_kernel[side][n]).abs().max()) / scales[n])
    print(f"phase train: kernels vs no_kernel(), one step from one state: {m_kernel} vs "
          f"{m_plain}; losses rel diff {loss_err:.3g} (tol 1e-4), Adam first moments "
          f"max|diff| / leaf scale {worst:.3g} (tol 1e-3)")
    check(loss_err <= 1e-4 and worst <= 1e-3, "the train step disagrees with no_kernel()")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = counts()
        metrics = {k: float(v) for k, v in step(batch).items()}    # host fetch per step
        launched = {k: v - before[k] for k, v in counts().items()}
        print(f"phase train: step {i}: {metrics}, launches {launched}")
        check(all(math.isfinite(v) for v in metrics.values()), f"step {i}: non-finite {metrics}")
        check(launched == TRAIN_LAUNCHES, f"step {i}: launches {launched}, "
              f"expected {TRAIN_LAUNCHES}")
    dt = time.perf_counter() - t0
    totals = counts()
    check(all(p.grad is not None and bool(p.grad.any()) for a in attns
              for p in a.parameters()), "an attention parameter has no gradient")
    for side, m in modules.items():
        live = {n for n, p in m.named_parameters() if p.grad is not None and bool(p.grad.any())}
        moved = {n for n, p in m.named_parameters()
                 if not torch.equal(p.detach(), start[side][n])}
        check(live <= moved, f"{side} parameters with a gradient did not move: "
              f"{sorted(live - moved)}")
        print(f"phase train: {len(moved)} of {len(list(m.parameters()))} {side} tensors "
              f"moved, every one of the {len(live)} with a nonzero gradient")
    print(f"phase train: batch {bench.BATCH}, {TRAIN_STEPS} steps in {dt:.3f} s, "
          f"{TRAIN_STEPS / dt:.3f} steps/s (each ended by a host fetch), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {totals}")
    return totals


CLI_CLIPS, CLI_EPOCHS, CLI_GP_EVERY = 80, 3, 2


def cli_argv(root, seed, *extra):
    """run_tganv2_cond.sh's flags with the regularization of r9_session.sh."""
    data = json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(root / "videos"), "num_frames": 16}})
    return ["--G", "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
            "--D", "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
            "--sent", "txt2vid_tpu.models.txt.Seq2Seq", "--data", data,
            "--anno", str(root / "sent.pickle"), "--vocab", str(root / "vocab.pickle"),
            "--frame_sizes", "8", "16", "32", "64", "--subsample_input", "--num_channels", "3",
            "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--G_lr", "0.0002",
            "--D_lr", "0.0002", "--G_beta2", "0.999", "--D_beta2", "0.999",
            "--gp_lambda", "0.5", "--gp_every", str(CLI_GP_EVERY), "--clip_grad", "100",
            "--g_ema", "0.999", "--batch_size", str(bench.BATCH), "--seed", str(seed),
            "--save_model_period", "4", "--log_period", "1", "--save_example_period", "4",
            "--sample_batch_size", "8", "--workers", "2", "--out", str(root / "out"),
            "--out_samples", str(root / "out" / "samples"), *extra]


class StepRecorder:
    """Wraps TrainStep.__call__ while installed: per step its launches, its
    metrics (fetched), whether it carried the GP, and its host-clock ms with
    the device synchronized; keeps the last step object and batch."""

    def __init__(self):
        self.steps, self.step, self.batch = [], None, None
        self._orig = TrainStep.__call__

    def __enter__(self):
        rec = self

        def call(step, batch, draws=None):
            it = step.step
            gp = step.config.gp_lambda > 0 and it % step.config.gp_every == 0
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            out = rec._orig(step, batch, draws)
            metrics = {k: float(v) for k, v in out.items()}
            ms = 1e3 * (time.perf_counter() - t0)
            launched = {k: v - before[k] for k, v in counts().items()}
            rec.steps.append({"iteration": it, "gp": gp, "ms": ms,
                              "metrics": metrics, "launches": launched})
            rec.step, rec.batch = step, batch
            return out

        TrainStep.__call__ = call
        return self

    def __exit__(self, *exc):
        TrainStep.__call__ = self._orig


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        elif v is not None:
            yield f"{prefix}/{k}", np.asarray(v)


def same_tree(a, b, what):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    check(fa.keys() == fb.keys(), f"{what}: the trees' leaves differ")
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype or not np.array_equal(fa[k], fb[k])]
    check(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(fa)


def phase_cli(seed):
    """The training CLI at the flagship's width; returns its launch counts."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_smoke_", dir=build))
    try:
        return _phase_cli(root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_cli(root, seed):
    t0 = time.perf_counter()
    sents = generate_examples(root / "videos", root / "sent.pickle", num_examples=CLI_CLIPS,
                              frame_size=(64, 64), num_frames=16, seed=seed, num_channels=3)
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab([c for v in sents.values() for c in v]), f)
    print(f"phase cli: {CLI_CLIPS} clips of 16x64x64x3 and a vocabulary of "
          f"{len(load_pickle(root / 'vocab.pickle'))} words in "
          f"{time.perf_counter() - t0:.2f} s")

    made = []
    init_ema = ema_mod.init_ema

    def recording_init_ema(gen):
        made.append(init_ema(gen))
        return made[-1]

    ema_mod.init_ema = recording_init_ema
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            train_gan.main(train_gan.build_parser().parse_args(
                cli_argv(root, seed, "--epochs", str(CLI_EPOCHS))))
    finally:
        ema_mod.init_ema = init_ema
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    totals = counts()
    peak = torch.cuda.max_memory_allocated()
    n_steps = CLI_EPOCHS * CLI_CLIPS // bench.BATCH
    check(len(rec.steps) == n_steps, f"{len(rec.steps)} steps run, {n_steps} expected")
    for r in rec.steps:
        print(f"phase cli: step {r['iteration']} ({'GP' if r['gp'] else 'plain'}): "
              f"{r['ms']:.2f} ms, {r['metrics']}, launches {r['launches']}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"cli step {r['iteration']}: non-finite {r['metrics']}")
        check(r["launches"] == TRAIN_LAUNCHES, f"cli step {r['iteration']}: launches "
              f"{r['launches']}, expected {TRAIN_LAUNCHES}")
    check([r["gp"] for r in rec.steps] == [i % CLI_GP_EVERY == 0 for i in range(n_steps)],
          "the GP did not run on the steps gp_every gives")
    print(f"phase cli: {n_steps} steps with the trainer (sampling and checkpoints at "
          f"iterations 4 and 6, the save of 4 overlapping steps 4-5) in {run_s:.2f} s; peak "
          f"memory {peak} bytes ({peak / 2**30:.3f} GiB); launches {totals}")

    out = root / "out"
    latest = checkpoint.latest_checkpoint(out)
    check(latest is not None and Path(latest).name.startswith(f"iter_{n_steps}_"),
          f"the last checkpoint is {latest}")
    step = rec.step
    mem = checkpoint.to_host(torch_state_to_jax(step))
    n_leaves = same_tree(mem, checkpoint.restore_state(mem, latest), "checkpoint")
    check(len(made) == 1, f"{len(made)} EMA averages made")
    ema_mem = checkpoint.to_host(ema_mod.ema_tree(made[0]))
    same_tree(ema_mem, checkpoint.restore_state(ema_mem, ema_mod.ema_path(latest)), "EMA")
    nbytes = Path(latest).stat().st_size
    t0 = time.perf_counter()
    checkpoint.save_state(torch_state_to_jax(step), root / "timed_save")
    save_s = time.perf_counter() - t0
    check((root / "timed_save").read_bytes() == Path(latest).read_bytes(),
          "a second save of the same state wrote other bytes")
    (root / "timed_save").unlink()
    print(f"phase cli: {Path(latest).name} reads back bit for bit ({n_leaves} leaves, Adam "
          f"counts {int(mem['opt_g_state']['0']['count'])}/"
          f"{int(mem['opt_d_state']['0']['count'])}), and its .ema; {nbytes} bytes, a "
          f"synchronous save {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s)")
    samples = sorted(p.name for p in (out / "samples").iterdir())
    check(any(n.startswith("fake_ema_samples_") for n in samples)
          and "real_samples.png" in samples, f"sample grids missing: {samples}")

    with StepRecorder() as resumed:
        train_gan.main(train_gan.build_parser().parse_args(
            cli_argv(root, seed, "--epochs", "1", "--resume")))
    its = [r["iteration"] for r in resumed.steps]
    check(its == [n_steps, n_steps + 1] and resumed.step.step == n_steps + 2,
          f"--resume ran counters {its}, ended at {resumed.step.step}")
    check(Path(checkpoint.latest_checkpoint(out)).name.startswith(f"iter_{n_steps + 2}_"),
          f"the resumed run's last checkpoint is {checkpoint.latest_checkpoint(out)}")
    print(f"phase cli: --resume --epochs 1 ran iterations {n_steps + 1}-{n_steps + 2} "
          f"(launches {[r['launches'] for r in resumed.steps]})")

    compare_kernel_and_plain_cli_step(resumed.step, resumed.batch)
    time_cli_steps(resumed.step, resumed.batch)
    gen = resumed.step.gan.gen
    avg = ema_mod.init_ema(gen)
    update = ema_mod.make_ema_update(0.999)
    ema_ms = cuda_ms(lambda: update(avg, gen))
    print(f"phase cli: EMA update of the generator's "
          f"{sum(p.numel() for p in gen.parameters())} parameters {ema_ms:.4f} ms")
    return totals


def _attention64(theta, phi, g, use_kernel=True):
    """The plain attention in the inputs' dtype (attention_core computes in
    float32), for the float64 reference step."""
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def compare_kernel_and_plain_cli_step(step, batch):
    """One GP step with clipping from one state, every attention gamma 1:
    with the kernels, under no_kernel() (twice: the run-to-run spread of the
    same code) and in float64 with the plain attention (the reference)."""
    check(step.config.gp_lambda > 0 and step.step % step.config.gp_every == 0,
          "the resumed state's next step carries no GP")
    modules = {"G": step.gan.gen, "D": step.gan.discrims[0]}
    with torch.no_grad():
        for m in modules.values():
            for a in m.modules():
                if isinstance(a, (Attention, Attention3d)):
                    a.gamma.fill_(1.0)
    start = checkpoint.to_host(torch_state_to_jax(step))
    draws = step.draw(batch["video"].shape[0], batch["video"].device)
    opts = {"G": step.opt_g, "D": step.opt_d}
    encoder = step.gan.cond_encoder

    def run(mode):
        jax_state_to_torch(start, step)
        if mode == "kernel":
            m = step(batch, draws)
        elif mode == "float64":
            for mod in (*modules.values(), encoder):
                mod.double()
            jax_state_to_torch(start, step)
            b64 = dict(batch, video=batch["video"].double() / 127.5 - 1.0)
            d64 = TrainStep.draw(step, batch["video"].shape[0], batch["video"].device)
            d64.z = draws.z.double()
            d64.alphas = [[a.double() for a in al] for al in draws.alphas]
            d64.perms = draws.perms
            orig = layers_mod.attention_core_auto
            layers_mod.attention_core_auto = _attention64
            try:
                m = step(b64, d64)
            finally:
                layers_mod.attention_core_auto = orig
        else:
            with no_kernel():
                m = step(batch, draws)
        out = ({k: float(v) for k, v in m.items()},
               {k: {n: opts[k].state[p]["exp_avg"].double().clone()
                    for n, p in modules[k].named_parameters()} for k in modules})
        if mode == "float64":
            for mod in (*modules.values(), encoder):
                mod.float()
        return out

    runs = {mode: run(mode) for mode in ("kernel", "plain", "plain again", "float64")}
    jax_state_to_torch(start, step)
    ref_m, ref = runs["plain"]

    def worst(mom, against):
        w, where = 0.0, None
        for side in modules:
            scales = leaf_scales(against[side])
            top = max(scales.values())
            for n, r in against[side].items():
                err = float((r - mom[side][n]).abs().max()) / scales[n]
                if err > w:
                    w, where = err, (f"{side} {n}, its max|moment| "
                                     f"{float(r.abs().max()) / top:.3g} of the phase's")
        return w, where

    loss_err = max(abs(runs["kernel"][0][k] - ref_m[k]) / abs(ref_m[k])
                   for k in ("loss_d", "loss_g"))
    kernel_vs_plain = worst(runs["kernel"][1], ref)
    print(f"phase cli: kernels vs no_kernel(), one GP step with clipping from one state: "
          f"{runs['kernel'][0]} vs {ref_m}; losses rel diff {loss_err:.3g} (tol 1e-4), Adam "
          f"first moments max|diff| / leaf scale {kernel_vs_plain[0]:.3g} at "
          f"{kernel_vs_plain[1]}")
    f64 = runs["float64"][1]
    vs64 = {}
    for mode in ("kernel", "plain", "plain again"):
        vs64[mode], where = worst(runs[mode][1], f64)
        print(f"phase cli: {mode} vs the float64 step: Adam first moments max|diff| / leaf "
              f"scale {vs64[mode]:.3g} at {where}")
    w, where = worst(runs["plain again"][1], ref)
    print(f"phase cli: no_kernel() run twice: max|diff| / leaf scale {w:.3g} at {where}")
    # at a trained state the plain float32 step itself can sit ~1e-3 of a leaf
    # scale from the float64 one (G's attention projections): there the
    # kernels pass when they are no further from float64 than 3x plain float32
    ok = kernel_vs_plain[0] <= 1e-3 or vs64["kernel"] <= 3 * vs64["plain"]
    print(f"phase cli: tolerances: losses 1e-4 relative; Adam first moments 1e-3 of the "
          f"leaf scale from no_kernel()'s, else no further from the float64 step than 3x "
          f"no_kernel()'s ({vs64['kernel']:.3g} vs 3 x {vs64['plain']:.3g}): "
          f"{'ok' if ok else 'DISAGREES'}")
    check(loss_err <= 1e-4 and ok, "the CLI's GP step disagrees with no_kernel()")


def time_cli_steps(step, batch, n=8):
    """n steps of the CLI's TrainStep on one batch, each timed alone on the
    host clock between device synchronizations (no checkpoint or sampling
    beside them); returns the median ms of the GP and of the plain steps
    after the first two."""
    times = {True: [], False: []}
    for i in range(n):
        gp = step.step % step.config.gp_every == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss_d"])
        ms = 1e3 * (time.perf_counter() - t0)
        check(math.isfinite(loss), f"timed step {i}: loss_d {loss}")
        if i >= 2:
            times[gp].append(ms)
    gp_ms, plain_ms = statistics.median(times[True]), statistics.median(times[False])
    print(f"phase cli: {n} steps alone, after 2 of warm-up: GP steps {times[True]} ms, plain "
          f"steps {times[False]} ms; medians {gp_ms:.2f} / {plain_ms:.2f} ms, GP overhead "
          f"{gp_ms / plain_ms - 1:.3f}")
    return gp_ms, plain_ms


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--baseline", metavar="DIR",
                   help="another checkout whose K1, K2 and K3 to time beside this one's")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU")

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    name, smi = timed("device", phase_device)
    tc = timed("build", phase_build)
    records = timed("kernels", lambda: [phase_attention(args.seed),
                                        *phase_attention_bwd(args.seed)])
    if args.baseline:
        timed("compare", phase_compare, args.baseline, args.seed)
    for r in records:
        r["tc_instructions"] = tc[r["name"]]
    serve_launches, _ = timed("serve", phase_serve, args.seed)
    train = timed("train", phase_train, args.seed)
    cli = timed("cli", phase_cli, args.seed)
    records[0]["launches"] = serve_launches
    for kernel, r in (("attention_fwd", records[0]["train_shape"]),
                      *((r["name"], r) for r in records[1:])):
        r["launches"] = train[kernel]
        r["launches_per_step"] = TRAIN_LAUNCHES[kernel]
    for r in records:
        r["cli_launches"] = cli[r["name"]]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
