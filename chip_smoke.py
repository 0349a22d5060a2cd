"""Drive txt2vid_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN, so
   the port's float32 runs in float32.
2. build: every CUDA kernel of the port, from txt2vid_tpu_torch/csrc, with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shape, the parity shapes of tpu_checks.py and a ragged shape,
   in float32 and bfloat16; then its time beside the plain version's and one
   PyTorch library call's that computes the same function.
4. serve: the caption->video service (txt2vid_tpu_torch.serve) at the width of
   the flagship conditional model, weights random from --seed and every
   attention gamma set to 1, answering 20 captions of mixed length in chunks of
   8. Launch counts are zeroed just before and read just after; the same
   requests with every kernel replaced by its plain version must agree.

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from txt2vid_tpu_torch.data import build_vocab
from txt2vid_tpu_torch.data.synthetic import moving_digit_captions
from txt2vid_tpu_torch.models.layers import Attention
from txt2vid_tpu_torch.ops import _build
from txt2vid_tpu_torch.ops.attention import no_kernel
from txt2vid_tpu_torch.ops.fused_attention import fused_attention, fused_attention_reference
from txt2vid_tpu_torch.serve import GeneratorService

# NVIDIA H100 SXM data sheet: HBM bandwidth, and float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# (B, N, M, d, dv): the generator's up1 attention at batch 8 (128 frames of
# 32x32), the parity shapes of tpu_checks.py, and a shape no tile divides
SERVE_SHAPE = (128, 1024, 256, 4, 16)
ATTENTION_SHAPES = [SERVE_SHAPE, (2, 1024, 256, 16, 64), (4, 4096, 1024, 16, 64),
                    (2, 1024, 256, 4, 16), (1, 64, 16, 16, 64), (3, 1000, 250, 4, 16)]
# float32: max|diff| <= 1e-4 * max(1, max|ref|), summation order only. bfloat16:
# the same bf16 inputs through the plain f32 version; the kernel rounds o to
# bf16 (8 bits of mantissa, 4e-3 relative), so o takes 1e-2, lse (f32) 1e-4.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}
NUM_CAPTIONS, BATCH = 20, 8


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
    """Median ms of one call, each timed alone with CUDA events."""
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


def attention_inputs(shape, dtype, seed):
    b, n, m, d, dv = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(size, generator=gen, device="cuda").to(dtype)
            for size in ((b, n, d), (b, m, d), (b, m, dv))]


def attention_bound_ms(shape, dtype):
    """The least time for o = softmax(theta phi^T) g: inputs read once and o
    written once over HBM bandwidth, or 2*B*N*M*(d + dv) float32 operations
    over the f32 peak, whichever is larger (exponentials not counted)."""
    b, n, m, d, dv = shape
    nbytes = torch.finfo(dtype).bits // 8 * (b * n * d + b * m * d + b * m * dv + b * n * dv)
    flops = 2 * b * n * m * (d + dv)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    seconds = _build.build_all()
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase build: {name}: {line.strip()}")
    print(f"phase build: {sorted(_build.SOURCES)} built in {seconds:.2f} s")


def phase_attention(seed):
    """K1 against its plain version at every shape and dtype; times at the
    serving shape. Returns the kernel's record for the JSON line."""
    serve_err = None
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

    theta, phi, g = attention_inputs(SERVE_SHAPE, torch.float32, seed)
    ms = cuda_ms(lambda: fused_attention(theta, phi, g))
    plain_ms = cuda_ms(lambda: fused_attention_reference(theta, phi, g))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(theta, phi, g, scale=1.0)
    sdpa_err, _ = max_err(fused_attention_reference(theta, phi, g), sdpa())
    library_ms = cuda_ms(sdpa)
    bound_ms, bound_by = attention_bound_ms(SERVE_SHAPE, torch.float32)
    print(f"phase kernels: attention_fwd at {SERVE_SHAPE} float32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
          f"(its max|diff| {sdpa_err:.3g}), bound {bound_ms:.4f} ms by {bound_by}")
    return {"name": "attention_fwd", "route": "cuda",
            "source": "txt2vid_tpu_torch/csrc/attention_fwd.cu",
            "replaces": "txt2vid_tpu/ops/pallas_attention.py:43",
            "launches": None, "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": list(SERVE_SHAPE), "dtype": "float32"}


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


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the GPU")

    name, smi = phase_device()
    phase_build()
    record = phase_attention(args.seed)
    record["launches"], _ = phase_serve(args.seed)
    print(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
