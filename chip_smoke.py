"""Drive txt2vid_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and prints no result line:

1. device: the card's name and power limit; TF32 off for matmuls and cuDNN, so
   the port's float32 runs in float32 (the CLI phases turn both back on before
   calling the CLI and check that its own setup turned them off).
2. build: every CUDA kernel of the port, from txt2vid_tpu_torch/csrc, with nvcc
   (registers, shared memory and spills as ptxas reports them), and the count
   of tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma) in each
   kernel's SASS, read with cuobjdump, summed and per instantiation (dtype,
   d, dv). Fails if an instantiation of K1, K2 or K3 has none.
3. kernels: each kernel (K1 the attention forward, K2 and K3 its backward)
   against its plain PyTorch version on the card, at the main paths' shapes,
   the parity shapes of tpu_checks.py, the cond-128 generator's (8, 32) width
   and ragged shapes, in float32 and bfloat16; K2 and K3 run twice at
   REPEAT_SHAPES must agree bit for bit; K2's and K3's splits at the cond-128
   shape. Then (phase float64) each kernel and its plain version against
   float64 at F64_SHAPES, with unit-scale inputs and at F64_SCALES: at unit
   scale the kernels' mean error toward zero must stay within BIAS_TOL of the
   shape (the tensor cores' truncating adds, which the kernels keep to one
   chunk at a time), at twice unit scale within BIAS_X2_TOL at every shape;
   at the other scales the drift is printed. At every
   scale the backward from K1's own lse and o must stray from float64 by at
   most OWN_RMS_TOL times the plain versions' path, in each gradient that
   float32 holds.
   Then each kernel's time beside the plain version's and one PyTorch library
   call's that computes the same function (per call, and per call in a CUDA
   graph where it captures), its bounds and the resident warps per SM, at
   the serving and training shapes, the cond-128 generator's shape (nested
   under "cond128_shape"), the 64-px discriminator's four training shapes
   (D_TRAIN_SHAPES, nested under "d_shapes") and the cond-128
   discriminator's three (COND128_D_SHAPES, under "cond128_d_shapes"). K1's
   record keeps the serving
   shape and the serve phase's launches; its training shape is nested under
   "train_shape". K2 and K3 records hold the training shape.
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
   nonzero gradient must have moved, the attention blocks' among them. Then
   the bench's float32 timing of that step (bench.measure) and a profile of
   3 steps, which phase bf16 prints beside the bf16 stack's.
6. cli: the training CLI as users run it. 80 synthetic clips (16x64x64x3)
   and a vocabulary written by the port's own generator to a directory under
   build/ (removed after phase eval), then `txt2vid_tpu_torch.train.gan.main`
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
7. cond128: the cond-128 flagship's float32 command line
   (scripts/r9_session.sh's run_chunk f32: G 128 px, 32 frames, 1 channel,
   additional_blocks [64, 32] with remat; D cond_head proj, down blocks
   [4, 4, 4]; frame sizes 32/64/128, RSGAN, GP 1.0 every 4 steps, clip 100
   split, EMA, batch 32) through `train.gan.main` in-process, for 3 epochs of
   2 batches of packed clips the port writes (64 synthetic 32x128x128x1 clips,
   pack_directory, the vocabulary from `python -m txt2vid_tpu_torch.data`)
   read through the native frame-cache reader. No --sent_weights: the encoder
   starts from the seed. Every step launches K1 14 and K2, K3 10 times (K1
   once more for the recomputed up0), with finite losses; the attention
   shapes (B, N, M, d, dv) of a step are the generator's (256, 4096, 1024, 8,
   32) and the discriminator's three scales. Then one step with the kernels
   against no_kernel() (as in cli),
   the peak memory and launches of a GP and a plain step with remat in G, off,
   and in G and D, 6 steps timed alone, and the last checkpoint served by
   `txt2vid_tpu_torch.serve.main`, live and with --ema: K1 once per chunk of
   8 at (256, 4096, 1024, 8, 32), the videos within 1e-4 (uint8 within 1) of
   the same service under no_kernel().
8. eval: the evaluation CLIs in-process on the last checkpoints of phases cli
   and cond128 (their data and checkpoints stay until this phase has run).
   The 64-px flagship: `txt2vid_tpu_torch.sample` with --format png and gif,
   each live and --ema, on 8 captions (the files, GIF89a, --ema not the live
   videos), `eval.run` on phase cli's clips with the discriminator FID (2
   batches of 32), `eval.alignment` with scripts/r4_ema64.sh:64-76's flags
   (--k_per_class 32 --seed 5, live and --ema) at phase cli's specs; cond-128:
   scripts/r9_eval_sweep.sh's `eval.run --num 256 --batch_size 16 --seed 5
   --no_discrim_fid` on phase cond128's packed clips and its `eval.alignment`.
   Every report finite, TF32 off after each CLI's main, fid_cls of eval.run's
   real clips against themselves at most 1e-6; the first sampling call at each
   (batch, video shape) repeated from the same z under no_kernel(), within
   1e-4; K1's launches counted against the number the batches give (one per
   generator batch, one per discriminator-feature batch) and its input shapes
   recorded; phase cli's clips and real_data_ceiling on them against this
   generator's CPU reading for --seed 0 (the clips' sha256 and the ceiling).
   Prints each CLI's seconds and the videos sampled per second.
9. bf16: bfloat16 compute through the same entry points. scripts/r4_ema64.sh's
   command line (the 64-px flagship with 1 channel and the proj head, GP 0.5
   every step, EMA, batch 40, --bf16 --bf16_nu) on 80 packed 16x64x64x1
   clips the port writes: 6 steps, each finite and launching K1 17 and K2, K3
   13 times, every launch a bf16 instantiation; the checkpoint's Adam moments
   bf16 under flax's name and read back bit for bit; --resume for 2 steps
   under the float32 config from that checkpoint and 2 more under the bf16
   one from the float32 checkpoint (each checkpoint byte for byte the
   encoding of the state in memory); GP and plain steps timed beside phase
   cli's float32 ones; one bf16 step with the kernels and one under
   no_kernel() against a float32 step of the same state (leaf by leaf, the
   kernels' Adam first moments no further from it than 2x the plain step's,
   that floored at two bf16 ulps of the leaf scale; losses within 2e-2; the
   leaves no loss reads, those whose float32 gradient in the same run is at
   most 1e-6 of their side's largest (the D heads' biases under RSGAN),
   printed with that reading and not held: `loss_free_leaves`).
   Then scripts/r9_session.sh's run_chunk bf16 (--bf16 --bf16_nu
   --bf16_params) at cond-128 on phase cond128's clips: 6 steps at
   14/10/10 launches, each step's finiteness, ms and the peak memory; where
   finite the same one-step check, where not the no_kernel() step from the
   state before the first non-finite one must be non-finite too; one step
   profiled. Then the
   service in bf16 (20 captions, batch 8) against no_kernel() (float 2e-2,
   uint8 within 2), and the port's bench with the JAX bench's bf16 stack
   (--bf16 --bf16_nu --bf16_params --shared_gen_fwd) and a profile of 3
   steps, beside phase train's float32 timing.
10. txt: the sentence-encoder pretraining, `txt2vid_tpu_torch.train.txt`
   in-process at full width (Seq2Seq 256/256/4, batch 64, --max_len 32, lr
   1e-4) on 1280
   captions of the synthetic grammar for 3 epochs (48 steps) with
   --save_every 16: finite losses, teacher-forced and free steps both run and
   each kind's loss falls, txt_iter_16/32/48 and txt_final written,
   txt_final byte for byte the encoding of the state in memory, and the
   training CLI's --sent_weights reader loads it into a fresh encoder that
   encodes alike. No attention kernel is on this path. Prints ms per step.
11. levers (after bf16, before families): the training CLI's single-card
   levers at full width, in four timed parts. (a) Phase cli's command line
   on 40 synthetic clips (one batch of 40 per epoch) with --end2end
   --gen_steps 2, with --end2end_d_only and with --sgd: 3 steps and
   --resume for 1, every step finite at train_launches' counts (27/18/18,
   18/13/13, 17/13/13), the encoder's moments nonzero in the optimizers
   that hold it (its gradient through cuDNN's LSTM backward, the encoder in
   training mode), 6 steps timed alone, and one --end2end --gen_steps 2 GP
   step with the kernels against no_kernel() by phase cli's rule. (b) r9's
   float32 command line with --device_data for 4 steps on phase cond128's
   clips: the cache's bytes on the card, GP and plain ms beside phase
   cond128's loader steps, one step on an assembled batch against the step
   on host_batch of the same indices (losses 1e-4, G's Adam first moments
   1e-3 of the leaf scale); then a cache of r3_queue14.sh's 8000 clips of
   32x128x128x1 uint8 from --seed (4 194 304 000 bytes): its upload, assemble
   at batch 32, the peak memory of one cond-128 GP step on it. (c) Phase
   cli's command line on 160 clips, 2 epochs (8 steps) with
   --steps_per_dispatch 4 against 1, cuDNN deterministic: the final states
   bit for bit (else no further apart than a second k = 1 run, twice over),
   the checkpoints at the iterations the JAX trainer's rule picks (save
   period 6: 8 with k = 4, 6 and 8 with k = 1), the EMA once per chunk with
   weight 1 - 0.999**4, and in the k = 4 run's profiler trace 2 host-to-
   device copies of a chunk's video (31 457 280 bytes) and none of one
   batch's. (d) utils.profiling.trace around one cond-128 GP and one plain
   step: the top 10 device kernels of each and format_memory_stats().

Each phase prints its seconds. The kernels line holds each kernel twice: its
float32 instantiations (K1 at the serving shape, K2 and K3 at the training
shape, the launches of phases serve and train) and its bfloat16 ones (at the
training shape, the launches of phase bf16's 64-px command line).

With --baseline DIR (another checkout's root, e.g. the parent commit's
`git archive` unpacked under build/), that checkout's K1, K2 and K3 are built
from its own sources; phase float64 reads their drift beside this one's, and
a phase compare after it times them beside this one's at the same shapes, in
float32 and bfloat16, in the order baseline, this, this, baseline.

K1's float32 record also holds phase eval's launches and shapes
("eval_launches", "eval_shapes"); each float32 record holds phase levers'
launches per run and per step ("levers_launches", "levers_launches_per_step").

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import dataclasses
import hashlib
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
from txt2vid_tpu_torch import sample as sample_mod
from txt2vid_tpu_torch import serve as serve_mod
from txt2vid_tpu_torch.convert import load_encoder_vars, torch_state_to_jax, txt_state_to_jax
from txt2vid_tpu_torch.data import build_vocab, load_pickle
from txt2vid_tpu_torch.data import packed
from txt2vid_tpu_torch.data.synthetic import generate_examples, moving_digit_captions
from txt2vid_tpu_torch.eval import alignment as alignment_mod
from txt2vid_tpu_torch.eval import classifier as classifier_mod
from txt2vid_tpu_torch.eval import run as run_mod
from txt2vid_tpu_torch.gan import ema as ema_mod
from txt2vid_tpu_torch.gan import trainer as trainer_mod
from txt2vid_tpu_torch.gan.train_step import TrainStep, adam
from txt2vid_tpu_torch.models import layers as layers_mod
from txt2vid_tpu_torch.models.layers import Attention, Attention3d
from txt2vid_tpu_torch.models.txt import Seq2Seq
from txt2vid_tpu_torch.ops import _build
from txt2vid_tpu_torch.ops import attention as attention_mod
from txt2vid_tpu_torch.ops.attention import no_kernel
from txt2vid_tpu_torch.ops.fused_attention import (
    SUPPORTED_DV, attention_bwd_dkv, attention_bwd_dkv_reference, attention_bwd_dq,
    attention_bwd_dq_reference, attention_delta, dkv_splits, dq_splits, fused_attention,
    fused_attention_reference, occupancy, sm_count)
from txt2vid_tpu_torch.ops.optim import AdamStorage
from txt2vid_tpu_torch.serve import GeneratorService
from txt2vid_tpu_torch.train import gan as train_gan
from txt2vid_tpu_torch.train import txt as txt_mod
from txt2vid_tpu_torch.utils import checkpoint, msgpack

# NVIDIA H100 SXM data sheet: HBM bandwidth, float32 outside the tensor cores,
# and TF32 on the tensor cores (dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12

# (B, N, M, d, dv): the generator's up1 attention serving batch 8 (128 frames
# of 32x32) and training batch 40 (after two subsamples, 40 frames of 32x32),
# the discriminator's Attention3d at the training pyramid's four scales, the
# parity shapes of tpu_checks.py, and shapes no tile divides (the last, with
# 3 chunks of 16 keys, is where K2 splits a query tile's keys 2 ways)
SERVE_SHAPE = (128, 1024, 256, 4, 16)
TRAIN_SHAPE = (40, 1024, 256, 4, 16)
D_TRAIN_SHAPES = [(40, 16, 4, 16, 64), (20, 32, 8, 16, 64), (10, 64, 16, 16, 64),
                  (5, 256, 64, 16, 64)]
# the cond-128 flagship generator's Attention(64) in up0: 16 videos x 16
# frames of 64x64 after the subsample in training at batch 32, and 8 videos x
# 32 frames when sampling or serving at batch 8; then a ragged shape at its width
COND128_SHAPE = (256, 4096, 1024, 8, 32)
# the cond-128 discriminator's Attention3d(128) after down0 at the three
# scales: the subsample pyramid halves the videos and the frames per scale (32
# x 32 frames of 32 px, 16 x 16 of 64 px, 8 x 8 of 128 px), and the stem's
# and down0's (1, 2, 2) stride-2 pools quarter T, H and W
COND128_D_SHAPES = [(32, 512, 128, 16, 64), (16, 1024, 256, 16, 64), (8, 2048, 512, 16, 64)]
ATTENTION_SHAPES = [SERVE_SHAPE, TRAIN_SHAPE, *D_TRAIN_SHAPES, (2, 1024, 256, 16, 64),
                    (4, 4096, 1024, 16, 64), (2, 1024, 256, 4, 16), (1, 64, 16, 16, 64),
                    (3, 1000, 250, 4, 16), (2, 45, 15, 16, 64), (2, 100, 40, 16, 64),
                    COND128_SHAPE, (3, 1000, 250, 8, 32), *COND128_D_SHAPES]
# K2 and K3 run twice on the same inputs must agree bit for bit here: the
# generators' shapes and the discriminator's largest (K2 splits its keys 4 ways)
REPEAT_SHAPES = [TRAIN_SHAPE, (5, 256, 64, 16, 64), COND128_SHAPE]
# float32: max|diff| <= 1e-4 * max(1, max|ref|), summation order only. bfloat16:
# the same bf16 inputs through the plain f32 version; the kernel rounds o to
# bf16 (8 bits of mantissa, 4e-3 relative), so o takes 1e-2, lse (f32) 1e-4.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}
# backward: float32 1e-4 * scale (summation order); bfloat16 1e-2 * scale, the
# kernel rounding its f32 result to bf16 once
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
NUM_CAPTIONS, BATCH = 20, 8


def train_launches(scales, remat_g=False, remat_d=False, gen_steps=1, end2end=False,
                   txt_in_g=True):
    """Attention launches per train step with one generator attention and
    the discriminator's at each of `scales` scales, counted from the code.

    The shared form (gen_steps 1 outside end2end). K1: 1 (generator) + 2 *
    scales (D phase: real_cc and fake_cc; real_ic reuses real_cc's features)
    + scales (the updated D's real predictions, no gradient) + scales (the G
    phase's fake pass). K2 and K3: 2 * scales (the D backward) + scales
    (through D to the fakes) + 1 (generator). The GP's forward and double
    backward take the plain attention, so a GP step launches what a plain one
    does. remat recomputes each wrapped block that carries an attention and
    is differentiated in the backward: K1 once more for the generator's
    (remat_g) and for each of the 3 * scales discriminator calls with a
    gradient (remat_d).

    The two-forward form (gen_steps g > 1, or end2end). K1: 1 (the D phase's
    fakes, no gradient) + 2 * scales (D phase) + scales (the real
    predictions, once, without gradient) + g * (1 + scales) (each G
    sub-step's generator and fake pass), and with remat_g once more per
    sub-step. Under end2end with the encoder in G's optimizer (txt_in_g) the
    real predictions move into each sub-step: 1 + 2 * scales + g * (1 + 2 *
    scales); their backward reaches the encoder through the cond alone, so
    no attention backward runs for them. K2 and K3: 2 * scales + g * (1 +
    scales). At the 64-px flagship (4 scales): --end2end --gen_steps 2 27 and
    18, --end2end_d_only 18 and 13."""
    if gen_steps == 1 and not end2end:
        fwd = 1 + 4 * scales + (1 if remat_g else 0) + (3 * scales if remat_d else 0)
        return {"attention_fwd": fwd, "attention_bwd_dq": 1 + 3 * scales,
                "attention_bwd_dkv": 1 + 3 * scales}
    check(not remat_d, "train_launches counts the two-forward form without remat in D")
    preds_per_sub = end2end and txt_in_g
    fwd = (1 + 2 * scales + (0 if preds_per_sub else scales)
           + gen_steps * (1 + scales + (scales if preds_per_sub else 0) + (1 if remat_g else 0)))
    bwd = 2 * scales + gen_steps * (1 + scales)
    return {"attention_fwd": fwd, "attention_bwd_dq": bwd, "attention_bwd_dkv": bwd}


# the 64-px flagship: 4 scales, no remat (17, 13, 13)
TRAIN_LAUNCHES = train_launches(4)
TRAIN_STEPS = 3
# steps that bench.profile traces for a device time per step
BENCH_PROFILE_STEPS = 3
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
    counted). In float32 returns {bound_ms, bound_by} against the f32 rate
    outside the tensor cores, as earlier records hold, and {tc_bound_ms,
    tc_bound_by} against three TF32 passes on the tensor cores, the float32
    design of the kernels; in bfloat16 both against one pass at the dense
    bf16 tensor-core rate."""
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
    rates = ((flops / PEAK_F32_FLOP_PER_S, 3 * flops / PEAK_TF32_FLOP_PER_S)
             if dtype == torch.float32 else (flops / PEAK_BF16_FLOP_PER_S,) * 2)
    out = {}
    for key, t_ops in zip(("", "tc_"), rates):
        out[f"{key}bound_ms"] = 1e3 * max(t_bytes, t_ops)
        out[f"{key}bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def tf32_on():
    """Both TF32 switches on, as a process that never turned them off may have
    them (torch's cuDNN default is on), so that a CLI call after this shows
    that the CLI itself turns them off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def check_tf32_off(phase):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"phase {phase}: after main, matmul.allow_tf32={flags[0]} "
          f"cudnn.allow_tf32={flags[1]} (both were on before it)")
    check(flags == (False, False), f"{phase}: main left TF32 on: {flags}")


def zero_counts():
    for k in KERNELS.values():
        k.launches = 0
        k.dtype_launches = dict.fromkeys(k.dtype_launches, 0)


def counts(dtype=None):
    """Each kernel's launches, or those of its `dtype` instantiation."""
    return {name: k.launches if dtype is None else k.dtype_launches[dtype]
            for name, k in KERNELS.items()}


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
        entry = name
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*\d((?:attention_fwd|attention_bwd_dq|"
                          r"attention_bwd_dkv|dkv_reduce)_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)ELi(\d+)E", line)
            if m:
                entry = (f"{m[1]}<{'float32' if m[2] == 'f' else 'bfloat16'}, d={m[3]}, "
                         f"dv={m[4]}>")
            elif "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"phase build: {entry}: {line.replace('ptxas info    :', '').strip()}")
    print(f"phase build: {sorted(_build.SOURCES)} built in {seconds:.2f} s")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    tc = {name: {"HMMA": 0, "HGMMA": 0} for name in KERNELS}
    per_inst = {}       # (kernel, dtype, d, dv) -> counts
    for lib in _build.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function : " in line:
                kernel = next((k for k in KERNELS if f"{k}_kernel" in line), None)
                # the mangled template arguments <T, D, DV>
                inst = re.search(r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", line)
                key = None if kernel is None or inst is None else (
                    kernel, "float32" if inst[1] == "f" else "bfloat16",
                    int(inst[2]), int(inst[3]))
                if key is not None:
                    per_inst[key] = {"HMMA": 0, "HGMMA": 0}
            elif kernel is not None:
                for op in tc[kernel]:
                    n = len(re.findall(rf"\b{op}\b", line))
                    tc[kernel][op] += n
                    if key is not None:
                        per_inst[key][op] += n
    for name, counts in tc.items():
        print(f"phase build: {name} SASS tensor-core instructions {counts}")
    for key, counts in sorted(per_inst.items()):
        print(f"phase build: {key[0]}<{key[1]}, d={key[2]}, dv={key[3]}> SASS "
              f"tensor-core instructions {counts}")
    insts = [(k, dt, d, dv) for k in TENSOR_CORE_KERNELS for dt in ("float32", "bfloat16")
             for d, dv in SUPPORTED_DV.items()]
    check(all(sum(per_inst.get(i, {}).values()) > 0 for i in insts),
          f"an instantiation of {TENSOR_CORE_KERNELS} has no tensor-core instruction "
          f"in its SASS: {per_inst}")
    return tc


def phase_attention(seed):
    """K1 against its plain version at every shape and dtype; times at the
    serving, the training, the cond-128 generator's and both discriminators'
    shapes. Returns the kernel's record for the JSON line (the serving shape's
    numbers, the others nested)."""
    errs = {}
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
            errs[shape, dtype] = err_o

    head = {"name": "attention_fwd", "route": "cuda",
            "source": "txt2vid_tpu_torch/csrc/attention_fwd.cu",
            "replaces": "txt2vid_tpu/ops/pallas_attention.py:43", "launches": None}
    f32 = torch.float32
    record, train, cond = (dict(time_forward(shape, seed), max_abs_err=errs[shape, f32])
                           for shape in (SERVE_SHAPE, TRAIN_SHAPE, COND128_SHAPE))
    # the bf16 instantiation's record holds the 64-px training shape, where
    # the bf16 command line launches it most
    bf16 = {shape: dict(time_forward(shape, seed, torch.bfloat16),
                        max_abs_err=errs[shape, torch.bfloat16])
            for shape in (TRAIN_SHAPE, SERVE_SHAPE, COND128_SHAPE)}
    return [{**head, **record, "train_shape": train, "cond128_shape": cond,
             "d_shapes": [time_forward(shape, seed) for shape in D_TRAIN_SHAPES],
             "cond128_d_shapes": [time_forward(shape, seed) for shape in COND128_D_SHAPES]},
            {**head, **bf16[TRAIN_SHAPE], "serve_shape": bf16[SERVE_SHAPE],
             "cond128_shape": bf16[COND128_SHAPE],
             "d_shapes": [time_forward(shape, seed, torch.bfloat16)
                          for shape in D_TRAIN_SHAPES],
             "cond128_d_shapes": [time_forward(shape, seed, torch.bfloat16)
                                  for shape in COND128_D_SHAPES]}]


def time_forward(shape, seed, dtype=torch.float32):
    """K1's time at `shape` in `dtype` beside its plain version's, SDPA's and
    its bounds, and the warps per SM it keeps resident."""
    theta, phi, g = attention_inputs(shape, dtype, seed)
    ms = cuda_ms(lambda: fused_attention(theta, phi, g))
    device_ms = graph_ms(lambda: fused_attention(theta, phi, g))
    plain_ms = cuda_ms(lambda: fused_attention_reference(theta, phi, g))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(theta, phi, g, scale=1.0)
    sdpa_err, _ = max_err(fused_attention_reference(theta, phi, g), sdpa())
    library_ms = cuda_ms(sdpa)
    library_device_ms = library_graph_ms(sdpa, "scaled_dot_product_attention")
    bound = bounds(shape, dtype, "attention_fwd")
    occ = occupancy("attention_fwd", shape, dtype)
    print(f"phase kernels: attention_fwd at {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms "
          f"(in a CUDA graph {device_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms (in a CUDA graph "
          f"{library_device_ms}; its max|diff| {sdpa_err:.3g}), "
          f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, tensor-core bound "
          f"{bound['tc_bound_ms']:.4f} ms by {bound['tc_bound_by']}, {occ}")
    return {"ms": ms, "graph_ms": device_ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms, "library_graph_ms": library_device_ms,
            "resident_warps_per_sm": occ["resident_warps_per_sm"],
            "shape": list(shape), "dtype": str(dtype)[6:]}


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
    repeatability; times at the generator's training shape (the records), the
    cond-128 generator's and both discriminators' shapes (nested). Returns
    their records."""
    errs_by_shape = {}
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
            errs_by_shape[shape, dtype] = {w: e for w, (e, _) in errs.items()}

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

    b, n, m = COND128_SHAPE[:3]
    sms = sm_count(0)
    print(f"phase kernels: at {COND128_SHAPE} on {sms} SMs K2 splits each query tile's "
          f"keys {dq_splits(b, n, m, sms)} way(s) over {b * -(-n // 64)} blocks, K3 cuts N "
          f"into {dkv_splits(b, n, m, sms)[0]} split(s) over {b * -(-m // 64)} blocks")
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        records = time_backward(TRAIN_SHAPE, seed, dtype)
        cond = time_backward(COND128_SHAPE, seed, dtype)
        per_shape = [time_backward(shape, seed, dtype) for shape in D_TRAIN_SHAPES]
        per_cond_shape = [time_backward(shape, seed, dtype) for shape in COND128_D_SHAPES]
        for i, r in enumerate(records):
            r["max_abs_err"] = max(errs_by_shape[TRAIN_SHAPE, dtype][w]
                                   for w in BWD_OUTPUTS[r["name"]])
            r["cond128_shape"] = {k: v for k, v in cond[i].items()
                                  if k not in ("name", "route", "source", "replaces", "launches")}
            r["cond128_shape"]["max_abs_err"] = max(errs_by_shape[COND128_SHAPE, dtype][w]
                                                    for w in BWD_OUTPUTS[r["name"]])
            r["d_shapes"] = [rs[i] for rs in per_shape]
            r["cond128_d_shapes"] = [rs[i] for rs in per_cond_shape]
        out.append(records)
    return out


def time_backward(shape, seed, dtype=torch.float32):
    """K2's and K3's times at `shape` in `dtype` beside their plain versions',
    the SDPA backward's (dtheta, dphi and dg together), their bounds and the
    warps per SM they keep resident."""
    args = bwd_inputs(shape, dtype, seed)
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
        bound = bounds(shape, dtype, name)
        warps = occupancy(name, shape, dtype)["resident_warps_per_sm"]
        print(f"phase kernels: {name} at {shape} {str(dtype)[6:]}: kernel {ms:.4f} ms (in a CUDA "
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
            "resident_warps_per_sm": warps, "shape": list(shape), "dtype": str(dtype)[6:]})
    print(f"phase kernels: scaled_dot_product_attention backward (dtheta, dphi, dg) at "
          f"{shape} {str(dtype)[6:]}: {library_ms:.4f} ms (in a CUDA graph {library_device_ms}; its "
          f"max|diff| {lib_err:.3g}); K2 + K3 {records[0]['ms'] + records[1]['ms']:.4f} ms "
          f"(in a CUDA graph {records[0]['graph_ms'] + records[1]['graph_ms']:.4f})")
    return records


# (B, N, M, d, dv) of the float64 check: the cond-128 generator's N and M at
# 8 batches (its float64 maps take 268 MB each), the 64-px training shape and
# the cond-128 discriminator's largest scale
F64_SHAPES = [(8, 4096, 1024, 8, 32), TRAIN_SHAPE, (8, 2048, 512, 16, 64)]
# the kernels' mean error toward zero over the mean |float64| at unit-scale
# inputs, per shape: above the largest reading of the kernels that add each
# chunk's product with rounding, below the smallest of the kernels that kept
# their sums in MMA fragments across the loop (PERF.md); the plain float32
# versions sit near 1e-8
BIAS_TOL = {F64_SHAPES[0]: 2e-6, TRAIN_SHAPE: 1e-6, F64_SHAPES[2]: 2e-6}
# the backward from a side's own forward, as a train step runs it: the
# kernels' RMS error against float64 at most OWN_RMS_TOL times the plain
# versions', for each gradient that float32 holds, the plain path within
# WELL_CONDITIONED (RMS over RMS) of float64. Where it does not (dtheta and
# dphi at the generator's logit scale: one-hot rows leave dS = p (dP -
# delta) as the difference of two rounded dot products) both paths' errors
# are rounding noise, printed only. With lse * log2 e rounded before the
# subtraction the kernels read up to 2.4x at unit scale, 2.5x to 8x at twice
# it and 182x for dg at the generator's logit scale; with s - lse formed
# first, 0.43x to 1.29x
OWN_RMS_TOL = 2.0
WELL_CONDITIONED = 1e-4
# input scales: 1 is held to BIAS_TOL, 2 to BIAS_X2_TOL; the others are
# printed only. The last puts the logits' standard deviation where phase
# cond128 finds it in a step at the seed's weights: about 7e3 in the
# generator's up0, 0.3-0.36 in the discriminator
F64_SCALES = {F64_SHAPES[0]: (1, 2, 50), TRAIN_SHAPE: (1, 2), F64_SHAPES[2]: (1, 2, 0.3)}
# at twice unit scale (logit std about 4x unit's) every shape's drift is held
# to this: with S's TF32 passes added in one accumulator K2 and K3 read 4.25e-6
# at (8, 2048, 512, 16, 64) against float64's lse
BIAS_X2_TOL = 2e-6


def float64_attention(theta, phi, g, do):
    """o, lse, dtheta, dphi, dg in float64 from float32 inputs."""
    t, f, v, o_ = (x.double() for x in (theta, phi, g, do))
    s = t @ f.transpose(1, 2)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = p @ v
    ds = p * (o_ @ v.transpose(1, 2) - (o_ * o).sum(-1)[..., None])
    return o, lse, ds @ f, ds.transpose(1, 2) @ t, p.transpose(1, 2) @ o_


def error_stats(ref, x):
    """Max, RMS and mean-toward-zero error of x against float64 ref, each
    over ref's max, RMS and mean |.|."""
    d = x.double() - ref
    return {"max": float(d.abs().max() / ref.abs().max()),
            "rms": float(d.square().mean().sqrt() / ref.square().mean().sqrt()),
            "bias": float((d * ref.sign()).mean() / ref.abs().mean())}


def logit_std(theta, phi):
    """The standard deviation of the first batch's logits theta . phi."""
    with torch.no_grad():
        return float((theta[0].float() @ phi[0].float().T).std())


def phase_float64(seed, base=None):
    """K1-K3, their plain versions and, given `base` (the --baseline
    checkout's fused_attention module), the baseline's kernels against
    float64 at F64_SCALES (the backward from the float64 forward's o and lse,
    so that each kernel's own error shows): at unit scale the kernels must not
    drift toward zero by more than BIAS_TOL, at twice it BIAS_X2_TOL. Then the backward from each
    side's own forward, as a train step runs it (a kernel's logits rounded
    otherwise than float64's then shift p against the float64 lse no more):
    at every scale the kernels' RMS error at most OWN_RMS_TOL times the plain
    versions' for each gradient float32 holds (WELL_CONDITIONED)."""
    for shape in F64_SHAPES:
        b, n, m, d, dv = shape
        for scale in F64_SCALES[shape]:
            theta, phi, g = (scale * x for x in attention_inputs(shape, torch.float32, seed))
            gen = torch.Generator(device="cuda").manual_seed(seed + 1)
            do = torch.randn((b, n, dv), generator=gen, device="cuda")
            refs = float64_attention(theta, phi, g, do)
            lse, delta = refs[1].float(), attention_delta(refs[0].float(), do)
            sides = [("kernels", fused_attention, attention_bwd_dq, attention_bwd_dkv),
                     ("plain", fused_attention_reference, attention_bwd_dq_reference,
                      attention_bwd_dkv_reference)]
            if base is not None and base.SUPPORTED_DV.get(d) == dv:
                sides.append(("baseline kernels", base.fused_attention, base.attention_bwd_dq,
                              base.attention_bwd_dkv))
            own_rms = {}
            for name, fwd, dq, dkv in sides:
                o, own_lse = fwd(theta, phi, g, return_lse=True)
                outs = (o, own_lse,
                        dq(theta, phi, g, do, lse, delta), *dkv(theta, phi, g, do, lse, delta))
                own_delta = attention_delta(o, do)
                own = (dq(theta, phi, g, do, own_lse, own_delta),
                       *dkv(theta, phi, g, do, own_lse, own_delta))
                torch.cuda.synchronize()
                stats = {w: error_stats(r, x)
                         for w, r, x in zip(("o", "lse", "dtheta", "dphi", "dg"), refs, outs)}
                print(f"phase float64: {name} at {shape} float32, inputs x{scale} (logit std "
                      f"{logit_std(theta, phi):.3g}) against float64: " + "; ".join(
                          f"{w} max {st['max']:.3g} rms {st['rms']:.3g} bias {st['bias']:.3g}"
                          for w, st in stats.items()))
                own_stats = {w: error_stats(r, x)
                             for w, r, x in zip(("dtheta", "dphi", "dg"), refs[2:], own)}
                own_rms[name] = {w: st["rms"] for w, st in own_stats.items()}
                print(f"phase float64: {name} at {shape}, inputs x{scale}, the backward from "
                      f"its own forward: " + "; ".join(
                          f"{w} rms {st['rms']:.3g} bias {st['bias']:.3g}"
                          for w, st in own_stats.items()))
                if name == "kernels" and scale in (1, 2):
                    worst = max(abs(st["bias"]) for st in stats.values())
                    tol = BIAS_TOL[shape] if scale == 1 else BIAS_X2_TOL
                    print(f"phase float64: kernels at {shape}, inputs x{scale}: largest "
                          f"drift {worst:.3g} (tol {tol:.3g})")
                    check(worst <= tol, f"the kernels drift toward zero at {shape} "
                          f"x{scale}: {stats}")
            held = [w for w, e in own_rms["plain"].items() if e <= WELL_CONDITIONED]
            ratio = max(own_rms["kernels"][w] / own_rms["plain"][w] for w in held)
            print(f"phase float64: at {shape}, inputs x{scale}, the kernels' backward from their "
                  f"own forward at most {ratio:.3g}x the plain versions' RMS error in {held} "
                  f"(tol {OWN_RMS_TOL})")
            check(ratio <= OWN_RMS_TOL, f"the kernels' path strays from float64 at {shape} "
                  f"x{scale}: {own_rms}")


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


def phase_compare(base, seed):
    """K1, K2 and K3 of the baseline checkout (its fused_attention module) and
    of this one, in float32 and bfloat16, timed in turns on the same inputs,
    each checked against this one's plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        compare_dtype(base, seed, dtype)


def compare_dtype(base, seed, dtype):
    this = sys.modules[fused_attention.__module__]
    for name, plain_fn, shapes in (
            ("fused_attention", fused_attention_reference,
             [SERVE_SHAPE, TRAIN_SHAPE, *D_TRAIN_SHAPES, COND128_SHAPE, *COND128_D_SHAPES]),
            ("attention_bwd_dq", attention_bwd_dq_reference,
             [TRAIN_SHAPE, *D_TRAIN_SHAPES, COND128_SHAPE, *COND128_D_SHAPES]),
            ("attention_bwd_dkv", attention_bwd_dkv_reference,
             [TRAIN_SHAPE, *D_TRAIN_SHAPES, COND128_SHAPE, *COND128_D_SHAPES])):
        for shape in shapes:
            if shape[3] not in base.SUPPORTED_DV:
                print(f"phase compare: the baseline has no kernel at (d, dv) = {shape[3:]}")
                continue
            args = (attention_inputs(shape, dtype, seed) if name == "fused_attention"
                    else bwd_inputs(shape, dtype, seed))
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
            print(f"phase compare: {name} at {shape} {str(dtype)[6:]}, (ms, ms in a CUDA graph, "
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


# the service in bf16 against itself under no_kernel(): the float video within
# 2e-2 (K1's o rounded to bf16 and every layer after it), uint8 within 2 levels
SERVE_TOL = {False: (1e-4, 1), True: (2e-2, 2)}


def phase_serve(seed, bf16=False, phase="serve"):
    """The flagship service on the card, in bf16 with `bf16`. Returns
    (launches, ms per video)."""
    vocab = build_vocab(moving_digit_captions(1000, seed))
    svc = GeneratorService.from_seed(vocab, seed=seed, batch_size=BATCH, device="cuda",
                                     bf16=bf16)
    attns = [m for m in svc.gan.gen.modules() if isinstance(m, Attention)]
    check(len(attns) == 1, f"flagship generator has {len(attns)} Attention blocks")
    with torch.no_grad():
        for m in attns:
            m.gamma.fill_(1.0)
    captions = mixed_captions(NUM_CAPTIONS, seed)
    n, chunks = svc._chunks(captions)
    lengths = sorted(set(svc._tokenize(captions)[1].tolist()))
    print(f"phase {phase}: {n} captions in {len(chunks)} chunks of {BATCH}, "
          f"token lengths {lengths}")
    check(len(lengths) > 1, "caption lengths are not mixed")

    svc.generate(sentences=captions, seed=seed + 1)           # warm-up: cuDNN, kernel load
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = svc.generate(sentences=captions, seed=seed)         # ends in the copy to the host
    dt = time.perf_counter() - t0
    launches = fused_attention.launches
    dtype = torch.bfloat16 if bf16 else torch.float32
    check(fused_attention.dtype_launches[dtype] == launches,
          f"the service launched K1's {fused_attention.dtype_launches} instantiations")

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
    tol, u8_tol = SERVE_TOL[bf16]
    print(f"phase {phase}: kernel vs plain attention: float max|diff| {worst:.3g} "
          f"(tol {tol}), uint8 max|diff| {u8_diff} (tol {u8_tol})")
    check(worst <= tol and u8_diff <= u8_tol, "the service disagrees with its plain version")
    ms_per_video = 1e3 * dt / NUM_CAPTIONS
    print(f"phase {phase}: uint8 {out.shape}, attention_fwd launches {launches}, "
          f"{ms_per_video:.3f} ms/video, {NUM_CAPTIONS / dt:.3f} videos/s")
    return launches, ms_per_video


def leaf_scales(moments):
    """name -> max|leaf|, floored at 1e-2 * the phase's largest: a gradient
    that is zero in exact arithmetic (a conv bias before a BatchNorm) holds
    float noise that differs between any two runs."""
    top = max(float(v.abs().max()) for v in moments.values())
    return {k: max(float(v.abs().max()), 1e-2 * top) for k, v in moments.items()}


def kernel_vs_plain_step(step, batch, phase):
    """phase train's rule: every attention gamma set to 1, one step from a
    copied state with the kernels and one under no_kernel() must agree
    (losses 1e-4 relative, Adam first moments 1e-3 of the leaf scale).
    Returns the attention blocks and the state before the step."""
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

    draws = step.draw(batch["video"].shape[0], "cuda")
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
    print(f"phase {phase}: kernels vs no_kernel(), one step from one state: {m_kernel} vs "
          f"{m_plain}; losses rel diff {loss_err:.3g} (tol 1e-4), Adam first moments "
          f"max|diff| / leaf scale {worst:.3g} (tol 1e-3)")
    check(loss_err <= 1e-4 and worst <= 1e-3, f"the {phase} step disagrees with no_kernel()")
    return attns, start


def phase_train(seed):
    """The bench's train step on the card, then the bench's float32 timing
    and profile of it (phase bf16 prints them beside the bf16 stack's).
    Returns the launch counts of its TRAIN_STEPS steps and the timing."""
    step, batch = bench.build(seed, bench.BATCH, "cuda")
    modules = {"G": step.gan.gen, "D": step.gan.discrims[0]}
    attns, start = kernel_vs_plain_step(step, batch, "train")

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
    del start                           # the bench's peak holds the step alone
    sec, _, peak = bench.measure(step, batch)
    prof = bench.profile(step, batch, BENCH_PROFILE_STEPS)
    f32 = {"dtype": "f32", "ms_per_step": 1e3 * sec, "peak_memory_bytes": peak}
    print(f"phase train: the bench's float32 timing of this step: {f32['ms_per_step']:.2f} "
          f"ms/step, {prof['device_ms_per_step']:.2f} device ms/step, busy share "
          f"{prof['device_busy_share']:.3f}, peak {peak} bytes; profile:")
    print(json.dumps(prof))
    return totals, (f32, prof)


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
    the device synchronized; keeps the last step object and batch. With
    `snapshot`, also a device copy of the state before each step, and that of
    the first step whose metrics are not finite (`bad`: its iteration, the
    state before it and its batch)."""

    def __init__(self, snapshot=False):
        self.steps, self.step, self.batch = [], None, None
        self.snapshot, self.bad = snapshot, None
        self._orig = TrainStep.__call__

    def __enter__(self):
        rec = self

        def call(step, batch, draws=None):
            it = step.step
            gp = step.config.gp_lambda > 0 and it % step.config.gp_every == 0
            state = StateSnapshot(step) if rec.snapshot and rec.bad is None else None
            torch.cuda.synchronize()
            before = counts()
            t0 = time.perf_counter()
            out = rec._orig(step, batch, draws)
            metrics = {k: float(v) for k, v in out.items()}
            if state is not None and not all(math.isfinite(v) for v in metrics.values()):
                rec.bad = (it, state, batch)
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


def leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}/{k}")
        elif v is not None:
            yield f"{prefix}/{k}", v


class StateSnapshot:
    """A device copy of a TrainStep's state: its modules' parameters and
    buffers, both optimizers' states and its counter. `restore` loads it into
    a TrainStep over the same modules (in their dtypes, float64 too), each
    moment in the dtype its optimizer stores it in (a bf16 AdamStorage's
    into torch's float32 Adam as float32)."""

    def __init__(self, step):
        gan = step.gan
        self.modules = [m for m in (gan.gen, *gan.discrims, gan.cond_encoder,
                                    gan.sample_mapping) if m is not None]
        self.tensors = [{n: t.detach().clone() for n, t in m.state_dict().items()}
                        for m in self.modules]
        self.opts = [{p: {k: v.clone() for k, v in st.items()} for p, st in opt.state.items()}
                     for opt in (step.opt_g, step.opt_d)]
        self.count = step.step

    def restore(self, step):
        with torch.no_grad():
            for m, saved in zip(self.modules, self.tensors):
                for n, t in m.state_dict().items():
                    t.copy_(saved[n])
        for opt, saved in zip((step.opt_g, step.opt_d), self.opts):
            opt.state.clear()
            for group in opt.param_groups:
                for p in group["params"]:
                    if p in saved:
                        opt.state[p] = {k: v.clone() if k == "step" else v.to(
                            moment_storage(opt, group, p, k), copy=True)
                            for k, v in saved[p].items()}
        step.step = self.count


def moment_storage(opt, group, p, key):
    """The dtype `opt` stores moment `key` of `p` in."""
    if isinstance(opt, AdamStorage):
        return opt.storage_dtype(group, p, key)
    return p.dtype


def _flat(tree):
    return ((k, np.asarray(v)) for k, v in leaves(tree))


def same_tree(a, b, what):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    check(fa.keys() == fb.keys(), f"{what}: the trees' leaves differ")
    bad = [k for k in fa if fa[k].dtype != fb[k].dtype or not np.array_equal(fa[k], fb[k])]
    check(not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}")
    return len(fa)


def phase_cli(seed, root):
    """The training CLI at the flagship's width, its data and checkpoints
    under root (phase eval reads them); returns its launch counts."""
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
    tf32_on()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            train_gan.main(train_gan.build_parser().parse_args(
                cli_argv(root, seed, "--epochs", str(CLI_EPOCHS))))
    finally:
        ema_mod.init_ema = init_ema
    torch.cuda.synchronize()
    check_tf32_off("cli")
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

    tf32_on()
    with StepRecorder() as resumed:
        train_gan.main(train_gan.build_parser().parse_args(
            cli_argv(root, seed, "--epochs", "1", "--resume")))
    check_tf32_off("cli")
    its = [r["iteration"] for r in resumed.steps]
    check(its == [n_steps, n_steps + 1] and resumed.step.step == n_steps + 2,
          f"--resume ran counters {its}, ended at {resumed.step.step}")
    check(Path(checkpoint.latest_checkpoint(out)).name.startswith(f"iter_{n_steps + 2}_"),
          f"the resumed run's last checkpoint is {checkpoint.latest_checkpoint(out)}")
    print(f"phase cli: --resume --epochs 1 ran iterations {n_steps + 1}-{n_steps + 2} "
          f"(launches {[r['launches'] for r in resumed.steps]})")

    step = resumed.step
    check(step.config.gp_lambda > 0 and step.step % step.config.gp_every == 0,
          "the resumed state's next step carries no GP")
    compare_kernel_and_plain_cli_step(step, resumed.batch)
    step_ms = time_cli_steps(resumed.step, resumed.batch)
    gen = resumed.step.gan.gen
    avg = ema_mod.init_ema(gen)
    update = ema_mod.make_ema_update(0.999)
    ema_ms = cuda_ms(lambda: update(avg, gen))
    print(f"phase cli: EMA update of the generator's "
          f"{sum(p.numel() for p in gen.parameters())} parameters {ema_ms:.4f} ms")
    latest = checkpoint.latest_checkpoint(out)
    for p in out.glob("iter_*"):
        if not str(p).startswith(latest):
            p.unlink()                  # phase eval reads the last one and its .ema
    return totals, step_ms


def _attention64(theta, phi, g, use_kernel=True):
    """The plain attention in the inputs' dtype (attention_core computes in
    float32), for the float64 reference step."""
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def compare_kernel_and_plain_cli_step(step, batch, phase="cli"):
    """One step (with the CLI's GP and clipping where its schedule puts them)
    from one state, every attention gamma 1: with the kernels, under
    no_kernel() (twice: the run-to-run spread of the same code) and, only
    where the kernels' step is further than 1e-3 of a leaf scale from
    no_kernel()'s, in float64 with the plain attention (the reference; at the
    cond-128 shape it holds float64 N x M maps of 8.6 GB)."""
    modules = {"G": step.gan.gen, "D": step.gan.discrims[0]}
    with torch.no_grad():
        for m in modules.values():
            for a in m.modules():
                if isinstance(a, (Attention, Attention3d)):
                    a.gamma.fill_(1.0)
    gp = step.config.gp_lambda > 0 and step.step % step.config.gp_every == 0
    start = StateSnapshot(step)
    draws = step.draw(batch["video"].shape[0], batch["video"].device)
    opts = {"G": step.opt_g, "D": step.opt_d}
    encoder = step.gan.cond_encoder

    def run(mode):
        start.restore(step)
        if mode == "kernel":
            m = step(batch, draws)
        elif mode == "float64":
            for mod in (*modules.values(), encoder):
                mod.double()
            start.restore(step)
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

    runs = {mode: run(mode) for mode in ("kernel", "plain", "plain again")}
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
    print(f"phase {phase}: kernels vs no_kernel(), one {'GP' if gp else 'plain'} step with "
          f"clipping from one state: {runs['kernel'][0]} vs {ref_m}; losses rel diff "
          f"{loss_err:.3g} (tol 1e-4), Adam first moments max|diff| / leaf scale "
          f"{kernel_vs_plain[0]:.3g} at {kernel_vs_plain[1]}")
    w, where = worst(runs["plain again"][1], ref)
    print(f"phase {phase}: no_kernel() run twice: max|diff| / leaf scale {w:.3g} at {where}")
    vs64 = {}
    if kernel_vs_plain[0] > 1e-3:
        runs["float64"] = run("float64")
        f64 = runs["float64"][1]
        for mode in ("kernel", "plain", "plain again"):
            vs64[mode], where = worst(runs[mode][1], f64)
            print(f"phase {phase}: {mode} vs the float64 step: Adam first moments max|diff| / "
                  f"leaf scale {vs64[mode]:.3g} at {where}")
    else:
        print(f"phase {phase}: within 1e-3 of no_kernel()'s step: no float64 step needed")
    start.restore(step)
    # at a trained state the plain float32 step itself can sit ~1e-3 of a leaf
    # scale from the float64 one (G's attention projections): there the
    # kernels pass when they are no further from float64 than 3x plain float32
    ok = kernel_vs_plain[0] <= 1e-3 or vs64["kernel"] <= 3 * vs64["plain"]
    print(f"phase {phase}: tolerances: losses 1e-4 relative; Adam first moments 1e-3 of the "
          f"leaf scale from no_kernel()'s, else no further from the float64 step than 3x "
          f"no_kernel()'s" + (f" ({vs64['kernel']:.3g} vs 3 x {vs64['plain']:.3g})" if vs64
                              else "") + f": {'ok' if ok else 'DISAGREES'}")
    check(loss_err <= 1e-4 and ok, f"the {phase} step disagrees with no_kernel()")


def profile_steps(step, batch, n, phase):
    """n steps of `step` under torch.profiler (bench.profile): device ms per
    step, the busy share and the top operators, printed; returns the dict."""
    prof = bench.profile(step, batch, n)
    print(f"phase {phase}: {n} steps profiled: {prof['device_ms_per_step']:.2f} device ms per "
          f"step of {prof['wall_ms_per_step']:.2f} on the host clock, busy share "
          f"{prof['device_busy_share']:.3f}; top operators by device ms: " + ", ".join(
              f"{o['name']} {o['device_ms_per_step']:.2f}" for o in prof["top_ops"][:6]))
    return prof


def time_cli_steps(step, batch, n=8, phase="cli"):
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
    print(f"phase {phase}: {n} steps alone, after 2 of warm-up: GP steps {times[True]} ms, plain "
          f"steps {times[False]} ms; medians {gp_ms:.2f} / {plain_ms:.2f} ms, GP overhead "
          f"{gp_ms / plain_ms - 1:.3f}")
    return gp_ms, plain_ms


# the cond-128 flagship's float32 command line (scripts/r9_session.sh:38-40,
# 60-78, run_chunk f32): its G and D specs verbatim (remat in G alone, as
# there), its flags verbatim but for the data paths, --sent_weights (no
# pretrained encoder here: the encoder starts from the seed), --epochs and
# the periods; packed clips the port writes (128x128, 32 frames, 1 channel)
COND128_G = ('{"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen", "args": '
             '{"num_channels": 1, "num_frames": 32, "width": 128, "height": 128, '
             '"additional_blocks": [64, 32], "fm_stride": 32, "remat": true}}')
COND128_D = ('{"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim", "args": '
             '{"num_channels": 1, "cond_head": "proj", "discrim_down_blocks": [4, 4, 4]}}')
COND128_FRAME_SIZES, COND128_FRAMES, COND128_BATCH = (32, 64, 128), 32, 32
COND128_CLIPS, COND128_EPOCHS, COND128_GP_EVERY = 64, 3, 4
COND128_STEPS = COND128_EPOCHS * COND128_CLIPS // COND128_BATCH
COND128_SCALES = len(COND128_FRAME_SIZES)
COND128_SERVE_SAMPLES = 16


def cond128_argv(root, seed, out=None):
    out = out or root / "out"
    data = json.dumps({"class": "txt2vid_tpu.data.packed.packed_dataset",
                       "args": {"data": str(root / "videos.t2vc"), "num_frames": COND128_FRAMES}})
    return ["--G", COND128_G, "--D", COND128_D, "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
            "--data", data, "--anno", str(root / "sent.pickle"),
            "--vocab", str(root / "vocab.pickle"),
            "--frame_sizes", *map(str, COND128_FRAME_SIZES), "--subsample_input",
            "--num_channels", "1", "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss",
            "--gp_lambda", "1.0", "--gp_every", str(COND128_GP_EVERY),
            "--G_lr", "0.0002", "--D_lr", "0.0001", "--G_beta2", "0.999", "--D_beta2", "0.999",
            "--clip_grad", "100", "--clip_grad_split", "--g_ema", "0.999",
            "--batch_size", str(COND128_BATCH), "--epochs", str(COND128_EPOCHS),
            "--seed", str(seed), "--log_period", "1",
            "--save_model_period", str(COND128_STEPS),
            "--save_example_period", str(COND128_STEPS), "--sample_batch_size", "8",
            "--out", str(out), "--out_samples", str(out / "samples")]


def smoke_dir(prefix):
    """A new directory under build/ (gitignored), for a phase's data."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=prefix, dir=build))


def cond128_data(root, seed):
    """COND128_CLIPS packed 32x128x128x1 clips and a vocabulary under root,
    written once (phases cond128 and bf16 share them)."""
    if (root / "vocab.pickle").exists():
        return
    t0 = time.perf_counter()
    size = COND128_FRAME_SIZES[-1]
    generate_examples(root / "videos", root / "sent.pickle", num_examples=COND128_CLIPS,
                      frame_size=(size, size), num_frames=COND128_FRAMES, seed=seed,
                      num_channels=1)
    n_packed = len(packed.pack_directory(root / "videos", root / "videos.t2vc"))
    subprocess.run([sys.executable, "-m", "txt2vid_tpu_torch.data", "--sents",
                    str(root / "sent.pickle"), "--out", str(root / "vocab.pickle")],
                   cwd=Path(__file__).resolve().parent, check=True, timeout=300,
                   capture_output=True)
    print(f"phase cond128: {n_packed} clips of {COND128_FRAMES}x{size}x{size}x1 packed into "
          f"{(root / 'videos.t2vc').stat().st_size} bytes, a vocabulary of "
          f"{len(load_pickle(root / 'vocab.pickle'))} words, in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_cond128(seed, root):
    """The cond-128 flagship's command line on the card, then its checkpoint
    served; returns its launch counts. Its data stay in root for phase bf16."""
    cond128_data(root, seed)
    return _phase_cond128(root, seed)


def _phase_cond128(root, seed):
    readers = []
    reader_init = packed.PackedReader.__init__

    def recording_init(self, *a, **k):
        reader_init(self, *a, **k)
        readers.append(self)

    want = train_launches(COND128_SCALES, remat_g=True)
    packed.PackedReader.__init__ = recording_init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tf32_on()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            train_gan.main(train_gan.build_parser().parse_args(cond128_argv(root, seed)))
    finally:
        packed.PackedReader.__init__ = reader_init
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_tf32_off("cond128")
    totals, peak = counts(), torch.cuda.max_memory_allocated()
    check(readers and all(r.native for r in readers),
          f"the packed dataset read {len(readers)} file(s), natively: "
          f"{[r.native for r in readers]}")
    print(f"phase cond128: the packed dataset reads through the native reader "
          f"({packed.native_library_path().name})")
    check(len(rec.steps) == COND128_STEPS,
          f"{len(rec.steps)} steps run, {COND128_STEPS} expected")
    for r in rec.steps:
        print(f"phase cond128: step {r['iteration']} ({'GP' if r['gp'] else 'plain'}): "
              f"{r['ms']:.2f} ms, {r['metrics']}, launches {r['launches']}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"cond128 step {r['iteration']}: non-finite {r['metrics']}")
        check(r["launches"] == want, f"cond128 step {r['iteration']}: launches "
              f"{r['launches']}, expected {want} (remat in G)")
    check([r["gp"] for r in rec.steps]
          == [i % COND128_GP_EVERY == 0 for i in range(COND128_STEPS)],
          "the GP did not run on the steps gp_every gives")
    step, batch = rec.step, rec.batch
    gen, disc = step.gan.gen, step.gan.discrims[0]
    check(gen.remat and not disc.remat, "G and D do not take the specs' remat")
    sampled = totals["attention_fwd"] - sum(r["launches"]["attention_fwd"] for r in rec.steps)
    latest = checkpoint.latest_checkpoint(root / "out")
    check(latest is not None and Path(latest).name.startswith(f"iter_{COND128_STEPS}_"),
          f"the last checkpoint is {latest}")
    nbytes = Path(latest).stat().st_size
    ema_bytes = Path(ema_mod.ema_path(latest)).stat().st_size
    print(f"phase cond128: {COND128_STEPS} steps with the trainer in {run_s:.2f} s, "
          f"launches per step (GP and plain alike) {want}, K1 {sampled} more in the "
          f"sampling at batch 8 (live and EMA generators); peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {Path(latest).name} {nbytes} bytes, its .ema "
          f"{ema_bytes} bytes; G {sum(p.numel() for p in gen.parameters())}, D "
          f"{sum(p.numel() for p in disc.parameters())} parameters")
    check(sampled == 2, f"the sampling launched K1 {sampled} times, 2 expected")

    compare_kernel_and_plain_cli_step(step, batch, phase="cond128")
    cond128_memory(step, batch)
    step_ms = time_cli_steps(step, batch, n=6, phase="cond128")
    serve = cond128_serve(root, latest, seed)
    return {"launches": totals, "per_step": want, "serve_launches": serve, "step_ms": step_ms}


def cond128_memory(step, batch):
    """Peak memory and launches of one GP and one plain step with remat off,
    in G alone (the specs') and in G and D; each must fit and launch what the
    code gives. Peak is the most allocated during the step; the state and the
    batch are allocated before it. Also the attention shapes of a step and the
    largest standard deviation of their logits (the scale phase float64
    reads its drift at)."""
    gen, disc = step.gan.gen, step.gan.discrims[0]
    shapes, orig = {}, layers_mod.attention_core_auto

    def recording(theta, phi, g, use_kernel=True):
        shape = (*theta.shape, phi.shape[1], g.shape[2])
        shapes[shape] = max(shapes.get(shape, 0.0), logit_std(theta, phi))
        return orig(theta, phi, g, use_kernel)

    for remat_g, remat_d in ((True, False), (False, False), (True, True)):
        gen.remat, disc.remat = remat_g, remat_d
        want = train_launches(COND128_SCALES, remat_g, remat_d)
        for gp in (True, False):
            while (step.step % step.config.gp_every == 0) != gp:
                step.step += 1
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = counts()
            layers_mod.attention_core_auto = recording
            try:
                loss = float(step(batch)["loss_d"])
            finally:
                layers_mod.attention_core_auto = orig
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in counts().items()}
            peak = torch.cuda.max_memory_allocated()
            print(f"phase cond128: remat G {remat_g} D {remat_d}, {'GP' if gp else 'plain'} "
                  f"step: peak memory {peak} bytes ({peak / 2**30:.3f} GiB; "
                  f"{(peak - base) / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB held "
                  f"before it), launches {launched}")
            check(math.isfinite(loss), f"remat step: loss_d {loss}")
            check(launched == want, f"remat G {remat_g} D {remat_d}: launches {launched}, "
                  f"expected {want}")
    gen.remat, disc.remat = True, False
    # (B, N, d) of theta with M and dv: the generator's up0 and the
    # discriminator's three scales
    stds = {(b, n, m, d, dv): std for (b, n, d, m, dv), std in shapes.items()}
    print(f"phase cond128: attention shapes (B, N, M, d, dv) in a step and the largest "
          f"standard deviation of their logits: "
          + ", ".join(f"{s} {std:.3g}" for s, std in sorted(stds.items())))
    check(sorted(stds) == sorted([COND128_SHAPE, *COND128_D_SHAPES]),
          f"attention shapes {sorted(stds)}, expected {[COND128_SHAPE, *COND128_D_SHAPES]}")


def cond128_serve(root, weights, seed):
    """The run's last checkpoint through `python -m txt2vid_tpu_torch.serve`'s
    main, live and --ema: K1 once per chunk, the videos against the same
    service under no_kernel() (float 1e-4, uint8 within 1). Returns K1's
    launches in the two runs."""
    sentences = moving_digit_captions(COND128_SERVE_SAMPLES, seed)
    chunks_n = -(-COND128_SERVE_SAMPLES // BATCH)
    made = []
    from_checkpoint = GeneratorService.from_checkpoint.__func__

    def recording(cls, *a, **k):
        made.append(from_checkpoint(cls, *a, **k))
        return made[-1]

    outs, launches = {}, 0
    for ema in (False, True):
        argv = ["--weights", weights, "--G", COND128_G, "--D", COND128_D,
                "--sent", "txt2vid_tpu.models.txt.Seq2Seq", "--vocab", str(root / "vocab.pickle"),
                "--frame_sizes", *map(str, COND128_FRAME_SIZES),
                "--num_frames", str(COND128_FRAMES), "--num_channels", "1",
                "--num_samples", str(COND128_SERVE_SAMPLES), "--sentences", *sentences,
                "--seed", str(seed), "--out_samples", str(root / f"served_{ema}"),
                *(["--ema"] if ema else [])]
        GeneratorService.from_checkpoint = classmethod(recording)
        try:
            torch.cuda.synchronize()
            fused_attention.launches = 0
            t0 = time.perf_counter()
            out = serve_mod.main(serve_mod.build_parser().parse_args(argv))
            dt = time.perf_counter() - t0
        finally:
            GeneratorService.from_checkpoint = classmethod(from_checkpoint)
        n = fused_attention.launches
        launches += n
        svc = made[-1]
        size = COND128_FRAME_SIZES[-1]
        check(out.dtype.name == "uint8"
              and out.shape == (COND128_SERVE_SAMPLES, COND128_FRAMES, size, size, 1),
              f"served {out.dtype} {out.shape}")
        check(n == chunks_n, f"K1 launched {n} times for {chunks_n} chunks")
        worst = 0.0
        for i, (toks, lens) in enumerate(svc._chunks(sentences)[1]):
            z = svc._draw_z(seed, i)
            video = svc._video(toks, lens, z)
            with no_kernel():
                plain = svc._video(toks, lens, z)
            check(bool(torch.isfinite(video).all()), f"chunk {i}: non-finite video")
            worst = max(worst, float((video - plain).abs().max()))
        with no_kernel():
            plain_u8 = svc.generate(sentences=sentences, seed=seed)
        u8_diff = int(abs(out.astype(int) - plain_u8.astype(int)).max())
        print(f"phase cond128: served {Path(weights).name}{' --ema' if ema else ''}: uint8 "
              f"{out.shape} (std {float(out.std()):.3f}) in {dt:.2f} s with the load, K1 "
              f"{n} launches for {chunks_n} chunks at {COND128_SHAPE}; kernel vs "
              f"no_kernel(): float max|diff| {worst:.3g} (tol 1e-4), uint8 max|diff| "
              f"{u8_diff} (tol 1)")
        check(worst <= 1e-4 and u8_diff <= 1, "the served checkpoint disagrees with "
              "its plain version")
        check(float(out.std()) > 0, "the served video is constant")
        outs[ema] = out
    check(not np.array_equal(outs[False], outs[True]), "--ema served the live generator")
    return launches


# phase bf16. The 64-px flagship's bf16 command line, scripts/r4_ema64.sh:38-52
# verbatim but for the data paths, --sent_weights (the encoder starts from the
# seed), --epochs and the periods: 1-channel G and proj-head D, GP 0.5 every
# step, EMA, batch 40, --bf16 --bf16_nu; on packed 16x64x64x1 clips the port
# writes
R4_G = ('{"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleGen", "args": '
        '{"num_channels": 1, "num_frames": 16}}')
R4_D = ('{"class": "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim", "args": '
        '{"num_channels": 1, "cond_head": "proj"}}')
R4_FLAGS = ("--bf16", "--bf16_nu")
# r9's run_chunk bf16 (scripts/r9_session.sh:55-78)
R9_BF16_FLAGS = ("--bf16", "--bf16_nu", "--bf16_params")
BF16_CLIPS, BF16_EPOCHS = 80, 3
BF16_STEPS = BF16_EPOCHS * BF16_CLIPS // bench.BATCH
# a bf16 step with the kernels against one under no_kernel(), both against a
# float32 step of the same state: leaf by leaf, the kernels' Adam first
# moments no further from it than BF16_STEP_RATIO times the plain step's,
# that floored at BF16_FLOOR of the leaf scale; the losses within
# BF16_LOSS_TOL of each other (bf16's rounding of a logit). The floor is two
# bf16 ulps: the moment's bf16 storage puts a leaf up to half of one off, and
# K2 and K3 round dS to bf16 as the TPU kernel does (pallas_attention.py:163)
# where the plain path keeps it in float32, which put theta's and phi's
# leaves up to 2.2 ulps from the float32 step through the kernels' plain
# versions on the CPU (tiny specs), against 0.24 for no_kernel()
BF16_STEP_RATIO, BF16_LOSS_TOL, BF16_FLOOR = 2.0, 2e-2, 2.0 ** -7


def r4_argv(root, seed, out, *extra):
    data = json.dumps({"class": "txt2vid_tpu.data.packed.packed_dataset",
                       "args": {"data": str(root / "videos.t2vc"), "num_frames": 16}})
    return ["--G", R4_G, "--D", R4_D, "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
            "--data", data, "--anno", str(root / "sent.pickle"),
            "--vocab", str(root / "vocab.pickle"), "--frame_sizes", "8", "16", "32", "64",
            "--subsample_input", "--num_channels", "1",
            "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--gp_lambda", "0.5",
            "--G_lr", "0.0002", "--D_lr", "0.0002", "--G_beta2", "0.999", "--D_beta2", "0.999",
            "--g_ema", "0.999", "--batch_size", str(bench.BATCH), "--seed", str(seed),
            "--log_period", "1", "--save_model_period", str(BF16_STEPS),
            "--save_example_period", str(BF16_STEPS), "--sample_batch_size", "8",
            "--workers", "2", "--out", str(out), "--out_samples", str(out / "samples"), *extra]


def set_compute_dtype(modules, dtype):
    """Every module's compute dtype (the layers' compute_dtype, the models'
    dtype) set to `dtype`; returns the old ones for restore_compute_dtype."""
    old = []
    for module in modules:
        for m in module.modules():
            for attr in ("compute_dtype", "dtype"):
                if attr in vars(m):
                    old.append((m, attr, vars(m)[attr]))
                    setattr(m, attr, dtype)
    return old


def restore_compute_dtype(old):
    for m, attr, value in old:
        setattr(m, attr, value)


def float32_step(step):
    """A float32 TrainStep over the same modules (set to compute in float32
    by the caller) with torch's Adam: the reference of a bf16 step."""
    def hyper(opt):
        g = opt.param_groups[0]
        b1, b2 = g["betas"] if "betas" in g else (g["b1"], g["b2"])
        return g["lr"], b1, b2
    gan = step.gan
    opt_g = adam(gan.gen.parameters(), *hyper(step.opt_g))
    opt_d = adam([p for d in gan.discrims for p in d.parameters()], *hyper(step.opt_d))
    return TrainStep(gan, step.losses, opt_g, opt_d,
                     dataclasses.replace(step.config, compute_dtype=None), step.seed)


def adam_gradients(step, start):
    """"side name" -> the gradient a step's Adam took at each leaf, from the
    first moments before it (StateSnapshot `start`, zeros where it had none)
    and after it: (m' - b1 m) / (1 - b1)."""
    out = {}
    for side, module, opt, saved in (("G", step.gan.gen, step.opt_g, start.opts[0]),
                                     ("D", step.gan.discrims[0], step.opt_d, start.opts[1])):
        g = opt.param_groups[0]
        b1 = g["betas"][0] if "betas" in g else g["b1"]
        for n, p in module.named_parameters():
            m = opt.state[p]["exp_avg"].float()
            before = saved.get(p, {"exp_avg": torch.zeros_like(m), "step": 0})
            check(int(opt.state[p]["step"]) == int(before["step"]) + 1,
                  f"adam_gradients: {side} {n} took more than one update in the step")
            out[f"{side} {n}"] = (m - b1 * before["exp_avg"].float()) / (1 - b1)
    return out


# a leaf whose float32 gradient is at most this share of its side's largest
# gradient is one no loss reads (zero but for rounding)
LOSS_FREE_TOL = 1e-6


def loss_free_leaves(grads):
    """The leaves no loss reads, as a float32 step's gradients (adam_gradients)
    show them: {"side name": max|g| over its side's largest max|g|} for each
    leaf at most LOSS_FREE_TOL. Under RSGAN every discriminator output enters
    a loss only as real - fake, so D's head biases cancel. In bf16 their
    moments hold the order in which autograd sums the bf16 parameter copy's
    gradients over the heads' uses, each partial sum rounded to bf16 (as JAX
    sums a bf16 cotangent): up to half a bf16 ulp of the head gradients, in
    an order that differs between the kernels' graph and no_kernel()'s, on a
    parameter whose value no loss sees."""
    out = {}
    for side in {k.split(" ", 1)[0] for k in grads}:
        reading = {k: float(g.abs().max()) for k, g in grads.items() if k.startswith(side + " ")}
        top = max(reading.values())
        out.update({k: r / top for k, r in reading.items() if r <= LOSS_FREE_TOL * top})
    return out


def compare_bf16_step(step, batch, phase):
    """One bf16 step from one state and set of draws, every attention gamma 1:
    with the kernels, under no_kernel(), and in float32 (no_kernel(), the
    same modules computing in float32, torch's Adam). Holds each leaf of the
    kernels' Adam first moments to BF16_STEP_RATIO x the plain step's
    distance from the float32 step's at that leaf (floored at BF16_FLOOR), and
    the two bf16 steps' losses to BF16_LOSS_TOL.
    Returns the metrics of the three runs."""
    modules = {"G": step.gan.gen, "D": step.gan.discrims[0]}
    with torch.no_grad():
        for m in modules.values():
            for a in m.modules():
                if isinstance(a, (Attention, Attention3d)):
                    a.gamma.fill_(1.0)
    gp = step.config.gp_lambda > 0 and step.step % step.config.gp_every == 0
    start = StateSnapshot(step)
    draws = step.draw(batch["video"].shape[0], batch["video"].device)

    grads = {}

    def run(mode):
        s = step
        old = None
        if mode == "float32":
            old = set_compute_dtype(modules.values(), None)
            s = float32_step(step)
        try:
            start.restore(s)
            with (contextlib.nullcontext() if mode == "kernel" else no_kernel()):
                m = {k: float(v) for k, v in s(batch, draws).items()}
            mom = {k: {n: opt.state[p]["exp_avg"].float().clone()
                       for n, p in modules[k].named_parameters()}
                   for k, opt in (("G", s.opt_g), ("D", s.opt_d))}
            if mode == "float32":
                grads.update(adam_gradients(s, start))
        finally:
            if old is not None:
                restore_compute_dtype(old)
        return m, mom

    runs = {mode: run(mode) for mode in ("kernel", "plain", "float32")}
    start.restore(step)
    ref = runs["float32"][1]

    def distance(mom):
        """"side name" -> max|diff| from the float32 step / leaf scale"""
        out = {}
        for side in modules:
            scales = leaf_scales(ref[side])
            for n, r in ref[side].items():
                out[f"{side} {n}"] = float((r - mom[side][n]).abs().max()) / scales[n]
        return out

    dist = {mode: distance(runs[mode][1]) for mode in ("kernel", "plain")}
    inert = loss_free_leaves(grads)
    # leaf by leaf: the kernels' distance over the plain step's, floored
    ratio = {k: dist["kernel"][k] / max(dist["plain"][k], BF16_FLOOR)
             for k in dist["plain"] if k not in inert}
    worst = max(ratio, key=ratio.get)
    finite = all(math.isfinite(v) for mode in runs for v in runs[mode][0].values())
    loss_err = max(abs(runs["kernel"][0][k] - runs["plain"][0][k]) / abs(runs["plain"][0][k])
                   for k in ("loss_d", "loss_g"))
    ok = finite and loss_err <= BF16_LOSS_TOL and ratio[worst] <= BF16_STEP_RATIO
    attn = [k for k in dist["plain"] if re.search(r"attn\.(theta|phi|g|o)\.", k)]
    print(f"phase {phase}: one bf16 {'GP' if gp else 'plain'} step from one state, kernels / "
          f"no_kernel() / float32: {runs['kernel'][0]} / {runs['plain'][0]} / "
          f"{runs['float32'][0]}; losses rel diff {loss_err:.3g} (tol {BF16_LOSS_TOL})")
    print(f"phase {phase}: Adam first moments' distance from the float32 step (max|diff| / "
          f"leaf scale), kernels / no_kernel(): largest {max(dist['kernel'].values()):.4g} / "
          f"{max(dist['plain'].values()):.4g}; attention projections " + ", ".join(
              f"{k} {dist['kernel'][k]:.4g} / {dist['plain'][k]:.4g}" for k in attn))
    if inert:
        print(f"phase {phase}: leaves no loss reads, their float32 gradient at most "
              f"{LOSS_FREE_TOL:g} of their side's largest (not held): " + ", ".join(
                  f"{k} gradient {inert[k]:.3g}, distance {dist['kernel'][k]:.4g} / "
                  f"{dist['plain'][k]:.4g}" for k in sorted(inert)))
    print(f"phase {phase}: leaf by leaf, kernels over max(no_kernel(), two bf16 ulps "
          f"{BF16_FLOOR:.4g}): largest {ratio[worst]:.4g} at {worst} ({dist['kernel'][worst]:.4g} "
          f"/ {dist['plain'][worst]:.4g}), tol {BF16_STEP_RATIO}: "
          f"{'ok' if ok else 'DISAGREES'}")
    check(ok, f"the {phase} bf16 step disagrees with no_kernel()")
    return runs


def moment_dtypes(mem, path):
    """The storage of a checkpoint's Adam moments and G's params: {"mu"/"nu"/
    "params": set of dtype names} over both optimizers. The file must be
    byte for byte the codec's encoding of `mem` (checkpoint.to_host of the
    state that wrote it), so it holds each leaf under the name of its dtype
    in memory (flax's "bfloat16" for a bf16 tensor)."""
    check(Path(path).read_bytes() == msgpack.packb(mem),
          f"{Path(path).name} is not the encoding of the state that wrote it")
    out = {"mu": set(), "nu": set(), "params": set()}

    def name(leaf):
        return "bfloat16" if isinstance(leaf, msgpack.BFloat16Array) else leaf.dtype.name
    for opt in ("opt_g_state", "opt_d_state"):
        for key in ("mu", "nu"):
            out[key].update(name(leaf) for _, leaf in leaves(mem[opt]["0"][key]))
    out["params"].update(name(leaf) for _, leaf in leaves(mem["g_vars"]["params"]))
    return out


def run_cli(argv, phase, want_launches, dtype, snapshot=False):
    """train.gan.main in-process on `argv`, TF32 on before it and checked off
    after; every step's metrics finite and launches `want_launches`, all of
    the `dtype` instantiations. Returns the StepRecorder."""
    tf32_on()
    zero_counts()
    with StepRecorder(snapshot) as rec:
        train_gan.main(train_gan.build_parser().parse_args(argv))
    check_tf32_off(phase)
    for r in rec.steps:
        print(f"phase {phase}: step {r['iteration']} ({'GP' if r['gp'] else 'plain'}): "
              f"{r['ms']:.2f} ms, {r['metrics']}, launches {r['launches']}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"{phase} step {r['iteration']}: non-finite {r['metrics']}")
        check(r["launches"] == want_launches, f"{phase} step {r['iteration']}: launches "
              f"{r['launches']}, expected {want_launches}")
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    check(not any(counts(other).values()), f"{phase}: {other} kernels launched: "
          f"{counts(other)}")
    return rec


def bf16_cli(root, seed, f32_ms):
    """r4_ema64's bf16 command line: 6 steps; --resume for 2 under the
    float32 config and 2 more under the bf16 one; the checkpoints' moments in
    their config's dtype under flax's names; a GP and a plain step timed
    beside phase cli's float32 ones; one step against no_kernel() and
    float32. Returns the bf16 launches of the first run."""
    t0 = time.perf_counter()
    sents = generate_examples(root / "videos", root / "sent.pickle", num_examples=BF16_CLIPS,
                              frame_size=(64, 64), num_frames=16, seed=seed, num_channels=1)
    packed.pack_directory(root / "videos", root / "videos.t2vc")
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab([c for v in sents.values() for c in v]), f)
    print(f"phase bf16: {BF16_CLIPS} clips of 16x64x64x1 packed, in "
          f"{time.perf_counter() - t0:.2f} s")
    out = root / "out"
    n_steps = BF16_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = run_cli(r4_argv(root, seed, out, *R4_FLAGS, "--epochs", str(BF16_EPOCHS)),
                  "bf16", TRAIN_LAUNCHES, torch.bfloat16)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts(torch.bfloat16)
    peak = torch.cuda.max_memory_allocated()
    check(len(rec.steps) == n_steps and all(r["gp"] for r in rec.steps),
          f"{len(rec.steps)} steps run ({n_steps} expected, each with the GP)")
    step = rec.step
    gen, disc = step.gan.gen, step.gan.discrims[0]
    check(gen.dtype == disc.dtype == torch.bfloat16 and step.config.compute_dtype is None,
          "r4's flags did not build bf16 G and D")
    check(all(p.dtype == torch.float32 for m in (gen, disc, step.gan.cond_encoder)
              for p in m.parameters()), "a stored parameter is not float32")
    latest = checkpoint.latest_checkpoint(out)
    check(latest is not None and Path(latest).name.startswith(f"iter_{n_steps}_"),
          f"the last checkpoint is {latest}")
    mem = checkpoint.to_host(torch_state_to_jax(step))
    dtypes = moment_dtypes(mem, latest)
    check(dtypes == {"mu": {"bfloat16"}, "nu": {"bfloat16"}, "params": {"float32"}},
          f"{Path(latest).name} holds {dtypes}")
    n_leaves = same_tree(mem, checkpoint.restore_state(mem, latest), "bf16 checkpoint")
    print(f"phase bf16: {n_steps} steps of r4_ema64's command line (--bf16 --bf16_nu, GP "
          f"every step) in {run_s:.2f} s, bf16 launches {launches}; peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {Path(latest).name} ({Path(latest).stat().st_size} "
          f"bytes) reads back bit for bit ({n_leaves} leaves), moments {dtypes}")

    # --resume under the float32 config from the bf16 checkpoint, then under
    # the bf16 one from the float32 checkpoint that run wrote
    chain = [("float32", ()), ("bf16", R4_FLAGS)]
    for i, (name, flags) in enumerate(chain):
        want_dtype = torch.bfloat16 if flags else torch.float32
        r = run_cli(r4_argv(root, seed, out, *flags, "--epochs", "1", "--resume"),
                    f"bf16 resume {name}", TRAIN_LAUNCHES, want_dtype)
        first = n_steps + 2 * i
        its = [s["iteration"] for s in r.steps]
        check(its == [first, first + 1] and r.step.step == first + 2,
              f"--resume under {name} ran counters {its}")
        latest = checkpoint.latest_checkpoint(out)
        dtypes = moment_dtypes(checkpoint.to_host(torch_state_to_jax(r.step)), latest)
        want = {"bfloat16"} if flags else {"float32"}
        check(dtypes["mu"] == dtypes["nu"] == want, f"{Path(latest).name} holds {dtypes}")
        print(f"phase bf16: --resume under the {name} config ran iterations "
              f"{first + 1}-{first + 2} from the previous run's checkpoint; "
              f"{Path(latest).name} holds moments {dtypes['mu']}")

    s = r.step      # the bf16 config's
    s.config = dataclasses.replace(s.config, gp_every=2)   # GP and plain steps
    gp_ms, plain_ms = time_cli_steps(s, r.batch, n=6, phase="bf16")
    s.config = dataclasses.replace(s.config, gp_every=1)
    print(f"phase bf16: r4_ema64's step, GP / plain ms: bf16 {gp_ms:.2f} / {plain_ms:.2f}, "
          f"phase cli's float32 flagship (3 channels) {f32_ms[0]:.2f} / {f32_ms[1]:.2f}")
    compare_bf16_step(s, r.batch, "bf16")
    return launches


def bf16_cond128(root, seed):
    """r9's run_chunk bf16 at cond-128 on phase cond128's packed clips: each
    step's finiteness, ms and launches, the peak memory; where the steps are
    finite, one step against no_kernel() and float32; where not, the same
    step under no_kernel() from the state before the first non-finite one
    must be non-finite too (then it is the model's, not the kernels')."""
    cond128_data(root, seed)
    out = root / "out_bf16"
    want = train_launches(COND128_SCALES, remat_g=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    tf32_on()
    aborted = None
    t0 = time.perf_counter()
    with StepRecorder(snapshot=True) as rec:
        try:
            train_gan.main(train_gan.build_parser().parse_args(
                cond128_argv(root, seed, out) + list(R9_BF16_FLAGS)))
        except SystemExit as e:     # NanAbort: exit 42, the finding is read below
            aborted = e.code
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_tf32_off("bf16 cond128")
    check(aborted in (None, 42), f"the cond-128 bf16 run exited {aborted}")
    peak = torch.cuda.max_memory_allocated()
    launches = counts(torch.bfloat16)
    check(not any(counts(torch.float32).values()), f"float32 kernels launched: {counts()}")
    for r in rec.steps:
        finite = all(math.isfinite(v) for v in r["metrics"].values())
        print(f"phase bf16 cond128: step {r['iteration']} ({'GP' if r['gp'] else 'plain'}): "
              f"{'finite' if finite else 'NOT FINITE'}, {r['ms']:.2f} ms, {r['metrics']}, "
              f"launches {r['launches']}")
        check(r["launches"] == want, f"bf16 cond128 step {r['iteration']}: launches "
              f"{r['launches']}, expected {want} (remat in G)")
    step = rec.step
    check(step.gan.gen.dtype == torch.bfloat16
          and step.config.compute_dtype == torch.bfloat16, "r9's bf16 flags did not apply")
    ms = [r["ms"] for r in rec.steps[2:]]
    print(f"phase bf16 cond128: r9's run_chunk bf16, {len(rec.steps)} steps in {run_s:.2f} s "
          f"({'exit 42' if aborted else 'to the end'}); ms per step after 2 "
          f"{ms} (median {statistics.median(ms) if ms else float('nan'):.2f}); peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB); bf16 launches {launches}")
    if rec.bad is None:
        check(len(rec.steps) == COND128_STEPS, f"{len(rec.steps)} steps run")
        compare_bf16_step(step, rec.batch, "bf16 cond128")
        profile_steps(step, rec.batch, 1, "bf16 cond128")
        return {"launches": launches, "finite": True}
    it, state, batch = rec.bad
    state.restore(step)
    with no_kernel():
        plain = {k: float(v) for k, v in step(batch).items()}
    plain_finite = all(math.isfinite(v) for v in plain.values())
    print(f"phase bf16 cond128: step {it} was not finite with the kernels; the same step "
          f"under no_kernel() from the state before it: {plain} "
          f"({'finite' if plain_finite else 'not finite: the model, not the kernels'})")
    check(not plain_finite, "the cond-128 bf16 step is non-finite with the kernels only")
    return {"launches": launches, "finite": False}


def bf16_bench(seed, f32):
    """The port's bench with the JAX bench's bf16 stack, beside phase train's
    float32 timing of the bench's step."""
    out = {"f32": f32}
    out["bf16 stack"] = bench.main(bench.build_parser().parse_args(
        ["--seed", str(seed), "--device", "cuda", "--profile", str(BENCH_PROFILE_STEPS),
         "--bf16", "--bf16_nu", "--bf16_params", "--shared_gen_fwd"]))
    print("phase bf16: bench ms/step, device ms/step, busy share, peak bytes: " + "; ".join(
        f"{name} ({line['dtype']}) {line['ms_per_step']:.2f}, {prof['device_ms_per_step']:.2f}, "
        f"{prof['device_busy_share']:.3f}, {line['peak_memory_bytes']}"
        for name, (line, prof) in out.items()))
    return out


def phase_bf16(seed, cond_root, f32_cli_ms, f32_serve_ms, f32_bench):
    """bfloat16 compute through the port's entry points. Returns the bf16
    launches of the 64-px command line (the main path), of the cond-128
    chunk and of serving."""
    t0 = time.perf_counter()

    def lap(what):
        nonlocal t0
        print(f"phase bf16: {what} in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()

    root = smoke_dir("bf16_smoke_")
    try:
        cli = bf16_cli(root, seed, f32_cli_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lap("the 64-px command line")
    cond = bf16_cond128(cond_root, seed)
    lap("the cond-128 chunk")
    serve_launches, serve_ms = phase_serve(seed, bf16=True, phase="bf16 serve")
    print(f"phase bf16 serve: {serve_ms:.3f} ms/video in bf16, {f32_serve_ms:.3f} in float32 "
          f"(phase serve)")
    lap("the service")
    bf16_bench(seed, f32_bench)
    lap("the bench")
    return {"cli": cli, "cond128": cond["launches"], "serve": serve_launches}


# phase families: the TCWYT, TGAN and image-GAN families through the training
# CLI at the full widths of scripts/run.sh and scripts/run_tgan.sh, and
# TGANv2's no_lstm generator (tganv2.py:97-107) in phase train's step
FAMILY_FRAMES, FAMILY_TIMED_STEPS = 16, 5
RUN_SH_BATCH, RUN_SH_CLIPS, RUN_SH_EPOCHS = 48, 96, 2       # 4 steps, then 2 resumed
IMG_BATCH, IMG_CLIPS, IMG_EPOCHS = 32, 64, 2                # 4 steps on 64-px clips
TGAN_BATCH, TGAN_CLIPS = 16, 32                             # 2 steps
CIFAR_IMAGES = 320                                          # one epoch: 10 steps
# no_lstm swaps the ConvLSTM for TGAN's seed generator and keeps every
# attention block, so its step launches what the 64-px flagship's does
NO_LSTM_LAUNCHES = train_launches(4)
NO_LSTM_STEPS = 2


def family_argv(root, name, seed, *args):
    out = root / name
    return [*args, "--seed", str(seed), "--log_period", "1", "--workers", "2",
            "--out", str(out), "--out_samples", str(out / "samples")]


def run_sh_argv(root, seed, *extra):
    """scripts/run.sh's flags verbatim but for the data paths and --epochs."""
    data = json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(root / "v48"), "num_frames": FAMILY_FRAMES}})
    return family_argv(
        root, "tcwyt", seed, "--G", "txt2vid_tpu.models.tcwyt.Gen",
        "--D", "txt2vid_tpu.models.tcwyt.VideoDiscrim", "txt2vid_tpu.models.tcwyt.FrameDiscrim",
        "txt2vid_tpu.models.tcwyt.MotionDiscrim", "--D_names", "video", "frame", "motion",
        "--M", "txt2vid_tpu.models.tcwyt.FrameMap", "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
        "--data", data, "--anno", str(root / "sent48.pickle"),
        "--vocab", str(root / "vocab.pickle"), "--frame_sizes", "48", "--num_channels", "3",
        "--D_loss", "txt2vid_tpu.gan.losses.RaLSGANLoss", "--G_lr", "0.0001",
        "--D_lr", "0.0001", "--batch_size", str(RUN_SH_BATCH), "--save_example_period", "4",
        "--sample_batch_size", "8", *extra)


def run_tgan_argv(root, seed, name, data, *extra):
    """scripts/run_tgan.sh's flags verbatim but for the data."""
    return family_argv(
        root, name, seed, "--G", "txt2vid_tpu.models.img.Gen",
        "--D", "txt2vid_tpu.models.img.Discrim", "--dont_use_sent", "--img_model",
        "--data", data, "--frame_sizes", "64", "--num_channels", "3",
        "--D_loss", "txt2vid_tpu.gan.losses.WassersteinGanLoss", "--discrim_steps", "5",
        "--gp_lambda", "10", "--batch_size", str(IMG_BATCH), *extra)


def family_cli(name, argv):
    """`train.gan.main` in-process on argv, TF32 on before it and checked off
    after; every step finite and launching no attention kernel (these
    families have none). Returns (recorder, the step's state as built, the
    seconds, the peak memory)."""
    built = []
    build = train_gan.build_train_step

    def capturing(*a, **k):
        step = build(*a, **k)
        built.append(StateSnapshot(step))
        return step

    train_gan.build_train_step = capturing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tf32_on()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with StepRecorder() as rec:
            train_gan.main(train_gan.build_parser().parse_args(argv))
    finally:
        train_gan.build_train_step = build
    torch.cuda.synchronize()
    seconds, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    check_tf32_off(f"families {name}")
    for r in rec.steps:
        print(f"phase families: {name} step {r['iteration']}: {r['ms']:.2f} ms, "
              f"{r['metrics']}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"families {name} step {r['iteration']}: non-finite {r['metrics']}")
    check(not any(counts().values()), f"families {name}: attention launched {counts()}")
    print(f"phase families: {name}: {len(rec.steps)} steps through the CLI in {seconds:.2f} "
          f"s, peak memory {peak} bytes ({peak / 2**30:.3f} GiB)")
    return rec, built[0], seconds, peak


def moved_and_frozen(step, start, name):
    """Every G and D parameter with a nonzero gradient has moved; M's
    parameters and statistics and every D's statistics are as they were,
    byte for byte."""
    gan = step.gan
    frozen = 0
    for m, saved in zip(start.modules, start.tensors):
        if m is gan.cond_encoder:
            continue
        is_m = m is gan.sample_mapping
        for n, p in m.named_parameters():
            same = torch.equal(p.detach(), saved[n])
            if is_m:
                check(same, f"families {name}: M's {n} moved")
                frozen += 1
            elif p.grad is not None and bool(p.grad.any()):
                check(not same, f"families {name}: {n} has a gradient and did not move")
        for n, b in m.named_buffers():
            if "running" in n and m is not gan.gen:
                check(torch.equal(b, saved[n]), f"families {name}: the statistic {n} moved")
                frozen += 1
    print(f"phase families: {name}: every G and D parameter with a gradient moved; "
          f"{frozen} tensors of M and of the discriminators' statistics unchanged")


def family_float64_step(step, batch, name):
    """One float32 step on the card against the same step in float64, from
    one copied state and one set of draws: losses within 1e-4 relative, each
    Adam first moment leaf within 1e-3 of its leaf scale (max|moment|
    floored at 1e-2 of its module's largest), or, where the worst leaf is
    further, no further than the same float32 step on the host's CPU (the
    limit the same comparison measures there; BatchNorm at batch statistics
    after each convolution cancels, so float32 strays at full width)."""
    gan = step.gan
    start = StateSnapshot(step)
    x = batch["video"]
    draws = step.draw(x.shape[0], x.device)
    sides = {"G": (gan.gen, step.opt_g),
             **{f"D{k}": (d, step.opt_d) for k, d in enumerate(gan.discrims)}}
    mods = [m for m in (gan.gen, *gan.discrims, gan.cond_encoder, gan.sample_mapping)
            if m is not None]

    def run(dtype, device="cuda"):
        for m in mods:
            m.to(device=device, dtype=dtype)
        start.restore(step)
        for opt in (step.opt_g, step.opt_d):
            for st in opt.state.values():
                st.update({k: v.to(device) for k, v in st.items() if k != "step"})
        b = {k: v if k == "lengths" else v.to(device) for k, v in batch.items()}
        if b["video"].dtype == torch.uint8:
            b["video"] = b["video"].to(dtype) / 127.5 - 1.0
        b["video"] = b["video"].to(dtype)
        d = dataclasses.replace(draws, z=draws.z.to(device, dtype),
                                perms=[p.to(device) for p in draws.perms])
        metrics = {k: float(v) for k, v in step(b, d).items()}
        moments = {side: {n: opt.state[p]["exp_avg"].double().cpu()
                          for n, p in m.named_parameters()} for side, (m, opt) in sides.items()}
        return metrics, moments

    def worst(mom, ref):
        w, where = 0.0, None
        for side in sides:
            scales = leaf_scales(ref[side])
            for n, r in ref[side].items():
                err = float((r - mom[side][n]).abs().max()) / scales[n]
                if err > w:
                    w, where = err, f"{side} {n}"
        return w, where

    m64, mom64 = run(torch.float64)
    m32, mom32 = run(torch.float32)
    loss_err = max(abs(m32[k] - m64[k]) / abs(m64[k]) for k in ("loss_d", "loss_g"))
    card, where = worst(mom32, mom64)
    print(f"phase families: {name}: a float32 step vs the float64 step from one state: "
          f"{m32} vs {m64}; losses rel diff {loss_err:.3g} (tol 1e-4), Adam first moments "
          f"max|diff| / leaf scale {card:.3g} at {where} (tol 1e-3)")
    limit = 1e-3
    if card > limit:
        t0 = time.perf_counter()
        _, mom_cpu = run(torch.float32, "cpu")
        limit, cpu_where = worst(mom_cpu, mom64)
        print(f"phase families: {name}: the same float32 step on the CPU ({torch.get_num_threads()} "
              f"threads, {time.perf_counter() - t0:.1f} s) vs the float64 step: {limit:.3g} at "
              f"{cpu_where}, the card's limit")
    for m in mods:
        m.to(device="cuda", dtype=torch.float32)
    start.restore(step)
    check(loss_err <= 1e-4 and card <= limit, f"families {name}: the float32 step strays "
          "from the float64 one")


def timed_family_steps(step, batch, name):
    """FAMILY_TIMED_STEPS steps of `step` alone on one batch; the median ms on
    the host clock between device synchronizations after 2 of warm-up."""
    times = []
    for i in range(FAMILY_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss_d"])
        times.append(1e3 * (time.perf_counter() - t0))
        check(math.isfinite(loss), f"families {name}: timed step {i}: loss_d {loss}")
    ms = statistics.median(times[2:])
    print(f"phase families: {name}: {FAMILY_TIMED_STEPS} steps alone {times} ms; median "
          f"after 2 of warm-up {ms:.2f} ms")
    return ms


def families_data(root, seed):
    """Synthetic 16-frame clips at 48 px (run.sh) and 64 px (the image GAN and
    TGAN), their captions and one vocabulary."""
    t0 = time.perf_counter()
    caps = []
    for size, n in ((48, RUN_SH_CLIPS), (64, IMG_CLIPS)):
        sents = generate_examples(root / f"v{size}", root / f"sent{size}.pickle",
                                  num_examples=n, frame_size=(size, size),
                                  num_frames=FAMILY_FRAMES, seed=seed, num_channels=3)
        caps += [c for v in sents.values() for c in v]
        if size == 64:          # TGAN's two steps: the first TGAN_CLIPS clips
            with open(root / "sent64_tgan.pickle", "wb") as f:
                pickle.dump({k: sents[k] for k in list(sents)[:TGAN_CLIPS]}, f)
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab(caps), f)
    cifar = root / "cifar" / "cifar-10-batches-py"
    cifar.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    with open(cifar / "data_batch_1", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (CIFAR_IMAGES, 3072), dtype=np.uint8),
                     b"labels": rng.integers(0, 10, CIFAR_IMAGES).tolist()}, f)
    print(f"phase families: {RUN_SH_CLIPS} clips of 16x48x48x3, {IMG_CLIPS} of 16x64x64x3, "
          f"{CIFAR_IMAGES} CIFAR-format images in {time.perf_counter() - t0:.2f} s")


def phase_families(seed):
    """Returns the no_lstm step's launch counts and the configurations'
    ms per step."""
    root = smoke_dir("families_smoke_")
    try:
        families_data(root, seed)
        return _phase_families(root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_families(root, seed):
    ms = {}
    # TCWYT at run.sh's full width: 4 steps, then --resume for 2
    rec, start, _, _ = family_cli("tcwyt", run_sh_argv(root, seed, "--epochs",
                                                         str(RUN_SH_EPOCHS)))
    n = RUN_SH_EPOCHS * RUN_SH_CLIPS // RUN_SH_BATCH
    check(len(rec.steps) == n, f"families tcwyt: {len(rec.steps)} steps, {n} expected")
    check(rec.step.gan.discrim_names == ["video", "frame", "motion"],
          f"families tcwyt: --D_names gave {rec.step.gan.discrim_names}")
    moved_and_frozen(rec.step, start, "tcwyt")
    resumed, _, _, _ = family_cli("tcwyt --resume",
                                  run_sh_argv(root, seed, "--epochs", "1", "--resume"))
    its = [r["iteration"] for r in resumed.steps]
    check(its == [n, n + 1], f"families tcwyt: --resume ran counters {its}")
    out = root / "tcwyt"
    latest = checkpoint.latest_checkpoint(out)
    check(Path(latest).name.startswith(f"iter_{n + 2}_"), f"the last checkpoint is {latest}")
    step, batch = resumed.step, resumed.batch
    mem = checkpoint.to_host(torch_state_to_jax(step))
    check(mem["m_vars"] is not None and all("batch_stats" in mem["d_vars"][k]
                                            for k in mem["d_vars"]),
          "families tcwyt: the checkpoint lacks m_vars or the discriminators' statistics")
    n_leaves = same_tree(mem, checkpoint.restore_state(mem, latest), "tcwyt checkpoint")
    nbytes = Path(latest).stat().st_size
    print(f"phase families: tcwyt: {Path(latest).name} reads back bit for bit ({n_leaves} "
          f"leaves, m_vars and the discriminators' statistics among them), {nbytes} bytes")
    family_float64_step(step, batch, "tcwyt")
    torch.cuda.reset_peak_memory_stats()
    ms["tcwyt"] = timed_family_steps(step, batch, "tcwyt")
    print(f"phase families: tcwyt: peak memory of the timed steps "
          f"{torch.cuda.max_memory_allocated()} bytes")
    del rec, start, resumed, step, batch
    spec = ["--weights", latest, "--G", "txt2vid_tpu.models.tcwyt.Gen",
            "--D", "txt2vid_tpu.models.tcwyt.VideoDiscrim",
            "txt2vid_tpu.models.tcwyt.FrameDiscrim", "txt2vid_tpu.models.tcwyt.MotionDiscrim",
            "--M", "txt2vid_tpu.models.tcwyt.FrameMap", "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
            "--vocab", str(root / "vocab.pickle"), "--frame_sizes", "48",
            "--num_frames", str(FAMILY_FRAMES), "--num_channels", "3"]
    videos, dt = run_eval_cli(sample_mod, spec + [
        "--format", "gif", "--sentences", *moving_digit_captions(4, seed),
        "--out_samples", str(root / "samples")], "sample --M")
    gifs = sorted((root / "samples").glob("sample_48x48_*.gif"))
    check(videos.shape == (4, 16, 48, 48, 3) and np.isfinite(videos).all() and len(gifs) == 4
          and all(g.read_bytes()[:6] == b"GIF89a" for g in gifs),
          f"families sample --M: {videos.shape}, {len(gifs)} GIFs")
    print(f"phase families: tcwyt: sample --M --format gif: 4 GIFs in {dt:.2f} s")
    report, dt = run_eval_cli(run_mod, spec + [
        "--data", str(root / "v48"), "--anno", str(root / "sent48.pickle"),
        "--num", str(RUN_SH_CLIPS), "--batch_size", str(RUN_SH_BATCH), "--no_discrim_fid"],
        "eval.run --M")
    finite_report(report, f"families eval.run --M ({dt:.2f} s)")
    report, dt = run_eval_cli(alignment_mod, spec + [
        "--k_per_class", "8", "--batch_size", "32", "--seed", "5"], "eval.alignment --M")
    finite_report({k: v for k, v in report.items() if k != "confusion"},
                  f"families eval.alignment --M ({dt:.2f} s)")

    # the image GAN at run_tgan.sh's flags: 4 steps on the clips' first frames
    data = json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(root / "v64"), "num_frames": FAMILY_FRAMES}})
    rec, start, _, _ = family_cli("img", run_tgan_argv(
        root, seed, "img", data, "--anno", str(root / "sent64.pickle"),
        "--epochs", str(IMG_EPOCHS)))
    n = IMG_EPOCHS * IMG_CLIPS // IMG_BATCH
    check(len(rec.steps) == n and rec.batch["video"].shape == (IMG_BATCH, 64, 64, 3),
          f"families img: {len(rec.steps)} steps on {tuple(rec.batch['video'].shape)}")
    moved_and_frozen(rec.step, start, "img")
    step, batch = rec.step, rec.batch
    gan = step.gan
    draws = step.draw(IMG_BATCH, "cuda")
    with torch.no_grad():
        fakes = gan.generate(draws.z, train=True)
    real = batch["video"].float() / 127.5 - 1.0
    gp = float(gan.gradient_penalty(0, draws.alphas[0], [real], fakes).detach())
    check(math.isfinite(gp) and gp > 0, f"families img: the gradient penalty {gp}")
    print(f"phase families: img: the critic's gradient penalty on a batch {gp:.4g}, "
          f"{Path(checkpoint.latest_checkpoint(root / 'img')).stat().st_size} checkpoint bytes")
    ms["img"] = timed_family_steps(step, batch, "img")
    del rec, start, step, batch, gan, fakes
    data = json.dumps({"class": "txt2vid_tpu.data.cifar10_dataset",
                       "args": {"data": str(root / "cifar")}})
    rec, _, _, _ = family_cli("img --data_is_imgs", run_tgan_argv(
        root, seed, "cifar", data, "--data_is_imgs", "--epochs", "1"))
    check(len(rec.steps) == CIFAR_IMAGES // IMG_BATCH
          and rec.batch["video"].shape == (IMG_BATCH, 64, 64, 3),
          f"families cifar: {len(rec.steps)} steps on {tuple(rec.batch['video'].shape)}")
    del rec

    # TGAN, conditional, 64 px, 16 frames: 2 steps
    data = json.dumps({"class": "txt2vid_tpu.data.my_dataset",
                       "args": {"data": str(root / "v64"), "num_frames": FAMILY_FRAMES}})
    rec, start, _, _ = family_cli("tgan", family_argv(
        root, "tgan", seed, "--G", "txt2vid_tpu.models.tgan.Gen",
        "--D", "txt2vid_tpu.models.tgan.Discrim", "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
        "--data", data, "--anno", str(root / "sent64_tgan.pickle"),
        "--vocab", str(root / "vocab.pickle"), "--frame_sizes", "64", "--num_channels", "3",
        "--D_loss", "txt2vid_tpu.gan.losses.RSGANLoss", "--batch_size", str(TGAN_BATCH),
        "--epochs", "1"))
    check(len(rec.steps) == TGAN_CLIPS // TGAN_BATCH, f"families tgan: {len(rec.steps)} steps")
    moved_and_frozen(rec.step, start, "tgan")
    print(f"phase families: tgan: "
          f"{Path(checkpoint.latest_checkpoint(root / 'tgan')).stat().st_size} checkpoint bytes")
    ms["tgan"] = timed_family_steps(rec.step, rec.batch, "tgan")
    del rec, start

    # TGANv2 no_lstm: the 64-px flagship with TGAN's seed generator
    step, batch = bench.build(seed, bench.BATCH, "cuda", no_lstm=True)
    check(step.gan.gen.no_lstm and not hasattr(step.gan.gen, "clstm"), "no_lstm has a ConvLSTM")
    attns, start = kernel_vs_plain_step(step, batch, "families no_lstm")
    print(f"phase families: no_lstm: predicted launches per step {NO_LSTM_LAUNCHES} "
          "(the flagship's: the same attention blocks)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for i in range(NO_LSTM_STEPS):
        before = counts()
        metrics = {k: float(v) for k, v in step(batch).items()}
        launched = {k: v - before[k] for k, v in counts().items()}
        print(f"phase families: no_lstm step {i}: {metrics}, launches {launched}")
        check(all(math.isfinite(v) for v in metrics.values()), f"no_lstm step {i}: {metrics}")
        check(launched == NO_LSTM_LAUNCHES, f"no_lstm step {i}: launches {launched}, "
              f"expected {NO_LSTM_LAUNCHES}")
    totals = counts()
    peak = torch.cuda.max_memory_allocated()
    gen = step.gan.gen
    check(not torch.equal(gen.frame_seed_gen.dc0.weight, start["G"]["frame_seed_gen.dc0.weight"]),
          "no_lstm: the seed generator did not move")
    ms["no_lstm"] = timed_family_steps(step, batch, "no_lstm")
    print(f"phase families: no_lstm: batch {bench.BATCH}, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), launches {totals}")
    print(f"phase families: ms per step (median after 2 warm-up steps): {json.dumps(ms)}")
    return {"launches": totals, "ms": ms}


# phase txt: the sentence-encoder pretraining at full width (scripts/run_sent.sh's
# train.txt: Seq2Seq 256/256/4, batch 64, --max_len 32, lr 1e-4) on
# TXT_CAPTIONS captions of the synthetic grammar, with --save_every 16
TXT_CAPTIONS, TXT_EPOCHS, TXT_BATCH, TXT_SAVE_EVERY = 1280, 3, 64, 16
TXT_STEPS = TXT_EPOCHS * (int(0.8 * TXT_CAPTIONS) // TXT_BATCH)


def phase_txt(seed):
    root = smoke_dir("txt_smoke_")
    try:
        return _phase_txt(root, seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_txt(root, seed):
    caps = moving_digit_captions(TXT_CAPTIONS, seed)
    with open(root / "sent.pickle", "wb") as f:
        pickle.dump({i: [c] for i, c in enumerate(caps)}, f)
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab(caps), f)
    steps = []
    make_step = txt_mod.make_step

    def recording_make_step(model, opt):
        step = make_step(model, opt)

        def timed(captions, lengths, teacher_force):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(captions, lengths, teacher_force))
            steps.append({"teacher_force": bool(teacher_force), "loss": loss,
                          "ms": 1e3 * (time.perf_counter() - t0)})
            return torch.tensor(loss)
        return timed

    txt_mod.make_step = recording_make_step
    tf32_on()
    zero_counts()
    t0 = time.perf_counter()
    try:
        model, opt = txt_mod.main(txt_mod.build_parser().parse_args([
            "--sentences", str(root / "sent.pickle"), "--vocab", str(root / "vocab.pickle"),
            "--out", str(root / "out"), "--epochs", str(TXT_EPOCHS),
            "--batch_size", str(TXT_BATCH), "--max_len", "32", "--lr", "1e-4",
            "--save_every", str(TXT_SAVE_EVERY), "--log_every", str(TXT_SAVE_EVERY),
            "--seed", str(seed)]))
    finally:
        txt_mod.make_step = make_step
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    check_tf32_off("txt")
    check(len(steps) == TXT_STEPS, f"txt: {len(steps)} steps run, {TXT_STEPS} expected")
    check(all(math.isfinite(s["loss"]) for s in steps), "txt: a non-finite loss")
    kinds = {tf: [s for s in steps if s["teacher_force"] == tf] for tf in (True, False)}
    check(all(len(v) >= 4 for v in kinds.values()),
          f"txt: {len(kinds[True])} teacher-forced and {len(kinds[False])} free steps")
    for tf, v in kinds.items():
        first = statistics.mean(s["loss"] for s in v[:3])
        last = statistics.mean(s["loss"] for s in v[-3:])
        print(f"phase txt: {'teacher-forced' if tf else 'free'} steps: {len(v)}, loss "
              f"{first:.4f} (mean of the first 3) -> {last:.4f} (the last 3), median "
              f"{statistics.median(s['ms'] for s in v[2:]):.2f} ms/step")
        check(last < first, f"txt: the {'teacher-forced' if tf else 'free'} loss did not fall")
    check(sum(counts().values()) == 0, "txt: an attention kernel was launched")
    out = root / "out"
    saved = sorted(p.name for p in out.iterdir() if p.name.startswith("txt_"))
    want = sorted([f"txt_iter_{i}" for i in range(TXT_SAVE_EVERY, TXT_STEPS + 1,
                                                   TXT_SAVE_EVERY)] + ["txt_final"])
    check(saved == want, f"txt: checkpoints {saved}, expected {want}")
    state = checkpoint.to_host(txt_state_to_jax(model, opt))
    check((out / "txt_final").read_bytes() == msgpack.packb(state),
          "txt: txt_final is not the encoding of the state in memory")
    # --sent_weights: train/gan.py's reader into a fresh encoder
    enc = Seq2Seq(vocab_size=model.encoder.embed.num_embeddings).cuda()
    with torch.no_grad():
        load_encoder_vars(enc, checkpoint.restore_txt_vars(out / "txt_final"))
    mine, theirs = enc.state_dict(), model.state_dict()
    check(mine.keys() == theirs.keys() and all(torch.equal(mine[k], theirs[k]) for k in mine),
          "txt: --sent_weights did not load the trained encoder")
    toks = torch.randint(1, enc.encoder.embed.num_embeddings, (8, 12), device="cuda")
    with torch.no_grad():
        check(torch.equal(enc.encode(toks)[2], model.encode(toks)[2]),
              "txt: the loaded encoder encodes otherwise")
    ms = statistics.median(s["ms"] for s in steps[2:])
    print(f"phase txt: {TXT_STEPS} steps of batch {TXT_BATCH} in {run_s:.2f} s with "
          f"validation and {len(saved)} checkpoints ({(out / 'txt_final').stat().st_size} "
          f"bytes), median {ms:.2f} ms/step; txt_final is the state in memory byte for "
          f"byte, and --sent_weights reads it into the encoder")
    return ms


# phase eval: the evaluation CLIs on the checkpoints of phases cli and cond128.
# The 64-px flagship: `sample` (png and gif, live and --ema), eval.run with the
# discriminator FID, and eval.alignment with scripts/r4_ema64.sh:64-76's flags
# (--k_per_class 32 --seed 5, live and --ema) at phase cli's specs (3 channels,
# the default D head); cond-128: r9_eval_sweep.sh:46-66's eval.run
# (--num 256 --batch_size 16 --seed 5 --no_discrim_fid, on phase cond128's
# packed clips) and eval.alignment (live)
EVAL_TOL = 1e-4
# phase cli's 80 clips for --seed 0, as this generator writes them on a CPU:
# the sha256 of the concatenated arrays and real_data_ceiling's reading
CLI_CLIPS_SHA256_SEED0 = "b9101ee805c18341e049e86feaca3514c9963be9ddb62617525b2db970061d64"
CEILING_SEED0 = {"real_accuracy_4way": 1.0, "real_accuracy_digit": 1.0, "n": 80}


class SampleCheck:
    """While installed, every gan/trainer.sample call (the sampling of the
    eval CLIs) is timed, and the first at each (batch, video shape) is
    repeated from the same z under no_kernel(): the final scales within
    EVAL_TOL of the scale. The attention forward's input shapes are recorded."""

    def __init__(self):
        self.orig = trainer_mod.sample
        self.orig_attn = attention_mod.fused_attention
        self.seen, self.shapes = {}, set()
        self.rate = {}                       # video shape -> [videos, seconds]

    def __enter__(self):
        chk = self

        def sample(gen, batch_size, generator, cond=None, latent_size=None):
            state = generator.get_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = chk.orig(gen, batch_size, generator, cond=cond, latent_size=latent_size)
            rate = chk.rate.setdefault(out[-1].shape[1:], [0, 0.0])
            rate[0] += batch_size
            rate[1] += time.perf_counter() - t0
            key = (batch_size, out[-1].shape[1:])
            if key not in chk.seen:
                with no_kernel():
                    plain = chk.orig(gen, batch_size, torch.Generator().set_state(state),
                                     cond=cond, latent_size=latent_size)
                ref = torch.from_numpy(plain[-1])
                err, scale = max_err(ref, torch.from_numpy(out[-1]))
                chk.seen[key] = err
                check(np.isfinite(out[-1]).all(), f"eval: non-finite videos at {key}")
                check(err <= EVAL_TOL * scale, f"eval: the sampled videos at {key} stray "
                      f"{err:.3g} from no_kernel()'s (tol {EVAL_TOL * scale:.3g})")
            return out

        def attention(theta, phi, g, return_lse=False):
            chk.shapes.add((*theta.shape[:2], phi.shape[1], theta.shape[2], g.shape[2]))
            return chk.orig_attn(theta, phi, g, return_lse=return_lse)

        trainer_mod.sample = sample_mod.sample = sample
        attention_mod.fused_attention = attention
        return self

    def __exit__(self, *exc):
        trainer_mod.sample = sample_mod.sample = self.orig
        attention_mod.fused_attention = self.orig_attn


def run_eval_cli(module, argv, what):
    """`module`'s main in-process on argv, TF32 on before it; returns
    (result, seconds)."""
    tf32_on()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = module.main(module.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_tf32_off(f"eval {what}")
    return out, dt


def finite_report(report, what):
    bad = {k: v for k, v in report.items()
           if isinstance(v, float) and not math.isfinite(v)}
    check(not bad, f"eval {what}: non-finite {bad}")
    print(f"phase eval: {what}: {json.dumps(report)}")


def phase_eval(seed, cli_root, cond_root):
    """Returns K1's launches and input shapes in the phase."""
    zero_counts()
    expect = 0
    with SampleCheck() as chk:
        weights = checkpoint.latest_checkpoint(cli_root / "out")
        spec = ["--weights", weights, "--G", "txt2vid_tpu.models.tganv2_cond.MultiScaleGen",
                "--D", "txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim",
                "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
                "--vocab", str(cli_root / "vocab.pickle"),
                "--frame_sizes", "8", "16", "32", "64", "--num_frames", "16",
                "--num_channels", "3"]
        made = {}
        for fmt, ema in (("png", False), ("png", True), ("gif", False), ("gif", True)):
            out_dir = cli_root / f"samples_{fmt}_{ema}"
            videos, dt = run_eval_cli(sample_mod, spec + [
                "--format", fmt, "--sentences", *moving_digit_captions(8, seed),
                "--seed", str(seed),
                "--out_samples", str(out_dir), *(["--ema"] if ema else [])],
                f"sample --format {fmt}{' --ema' if ema else ''}")
            files = sorted(p.name for p in out_dir.iterdir())
            want = (["sample_64x64.png"] if fmt == "png"
                    else [f"sample_64x64_{i}.gif" for i in range(8)])
            check(files == want, f"eval sample: wrote {files}")
            if fmt == "gif":
                check(all((out_dir / n).read_bytes()[:6] == b"GIF89a" for n in files),
                      "eval sample: not a GIF")
            check(videos.shape == (8, 16, 64, 64, 3) and np.isfinite(videos).all(),
                  f"eval sample: videos {videos.shape}")
            made[fmt, ema] = videos
            expect += 1
            print(f"phase eval: sample --format {fmt}{' --ema' if ema else ''}: {len(files)} "
                  f"files in {dt:.2f} s with the checkpoint's load")
        for fmt in ("png", "gif"):
            check(not np.allclose(made[fmt, False], made[fmt, True], rtol=0, atol=1e-3),
                  f"eval sample --format {fmt}: --ema sampled the live generator's videos")

        captured = {}
        report_fn = run_mod.sample_fidelity_report

        def capturing(real, fake, **kw):
            captured["real"], captured["fake"] = real, fake
            return report_fn(real, fake, **kw)

        run_mod.sample_fidelity_report = capturing
        try:
            report, dt = run_eval_cli(run_mod, spec + [
                "--data", str(cli_root / "videos"), "--anno", str(cli_root / "sent.pickle"),
                "--batch_size", "32", "--seed", str(seed)], "eval.run 64 px")
        finally:
            run_mod.sample_fidelity_report = report_fn
        finite_report(report, f"eval.run 64 px ({dt:.2f} s)")
        n_real = len(captured["real"])
        check({"fid_random_conv", "fid_discrim", "fid_cls"} <= set(report) and n_real == 64,
              f"eval.run: {sorted(report)} over {n_real} clips")
        expect += 2 * (n_real // 32) + n_real // 32     # G per batch, D on real and fake
        self_fid = classifier_mod.classifier_fid(captured["real"], captured["real"],
                                                 batch_size=32, device="cuda")
        print(f"phase eval: fid_cls of the {n_real} real clips against themselves "
              f"{self_fid:.3g} (limit 1e-6)")
        check(self_fid <= 1e-6, "eval: fid_cls of a clip set against itself")

        for ema in (False, True):
            report, dt = run_eval_cli(alignment_mod, spec + [
                "--k_per_class", "32", "--seed", "5", *(["--ema"] if ema else [])],
                f"eval.alignment 64 px{' --ema' if ema else ''}")
            finite_report(report, f"eval.alignment 64 px{' --ema' if ema else ''} "
                                  f"({dt:.2f} s)")
            check(report["n"] == 128, f"eval.alignment: n {report['n']}")
            expect += -(-128 // 40)

        h = hashlib.sha256()
        for i in range(CLI_CLIPS):
            h.update(np.load(cli_root / "videos" / f"{i}.npy").tobytes())
        ceiling = alignment_mod.real_data_ceiling(cli_root / "videos", cli_root / "sent.pickle")
        print(f"phase eval: real_data_ceiling on phase cli's clips {ceiling}; the clips' "
              f"sha256 {h.hexdigest()}")
        if seed == 0:
            check(h.hexdigest() == CLI_CLIPS_SHA256_SEED0 and ceiling == CEILING_SEED0,
                  "eval: phase cli's clips or their ceiling differ from the CPU's for seed 0")

        weights = checkpoint.latest_checkpoint(cond_root / "out")
        spec = ["--weights", weights, "--G", COND128_G, "--D", COND128_D,
                "--sent", "txt2vid_tpu.models.txt.Seq2Seq",
                "--vocab", str(cond_root / "vocab.pickle"),
                "--frame_sizes", *map(str, COND128_FRAME_SIZES),
                "--num_frames", str(COND128_FRAMES), "--num_channels", "1"]
        data = json.dumps({"class": "txt2vid_tpu.data.packed.packed_dataset",
                           "args": {"data": str(cond_root / "videos.t2vc")}})
        report, dt = run_eval_cli(run_mod, spec + [
            "--data", data, "--anno", str(cond_root / "sent.pickle"), "--num", "256",
            "--batch_size", "16", "--seed", "5", "--no_discrim_fid"], "eval.run cond-128")
        finite_report(report, f"eval.run cond-128 ({dt:.2f} s)")
        check("fid_cls" in report and "fid_discrim" not in report,
              f"eval.run cond-128: {sorted(report)}")
        expect += COND128_CLIPS // 16
        report, dt = run_eval_cli(alignment_mod, spec + ["--k_per_class", "32", "--seed", "5"],
                                  "eval.alignment cond-128")
        finite_report(report, f"eval.alignment cond-128 ({dt:.2f} s)")
        expect += -(-128 // 40)
    launches = fused_attention.launches
    for shape, (n, sec) in chk.rate.items():
        print(f"phase eval: sampled {n} videos of {tuple(shape)} in {sec:.3f} s, "
              f"{n / sec:.2f} videos/s (host clock, synchronized; each CLI's first call "
              f"included)")
    print(f"phase eval: K1 launches {launches} (expected {expect}) at (B, N, M, d, dv) "
          f"{sorted(chk.shapes)}; kernel vs no_kernel() max|diff| per (batch, shape) "
          f"{ {f'{b} x {tuple(s)}': f'{e:.3g}' for (b, s), e in chk.seen.items()} }")
    check(launches == expect and fused_attention.dtype_launches[torch.float32] == launches,
          f"eval: K1 launched {launches} times, {expect} expected")
    return {"launches": launches, "shapes": sorted(chk.shapes)}


# phase levers: the training CLI's single-card levers at full width. Part a
# trains on LEVERS_E2E_CLIPS clips (one batch of bench.BATCH per epoch, so
# --epochs gives the steps), part c on all LEVERS_CLIPS (four batches per
# epoch, one chunk of --steps_per_dispatch 4)
LEVERS_CLIPS, LEVERS_E2E_CLIPS, LEVERS_STEPS = 160, 40, 3
LEVERS_RUNS = {
    "end2end_gen2": (("--end2end", "--gen_steps", "2"),
                     train_launches(4, gen_steps=2, end2end=True)),
    "end2end_d_only": (("--end2end_d_only",),
                       train_launches(4, end2end=True, txt_in_g=False)),
    "sgd": (("--sgd",), TRAIN_LAUNCHES),
}
# r3_queue14.sh's resident data set: 8000 clips of 32x128x128x1 uint8
BIG_CACHE = (8000, 32, 128, 128, 1)
DISPATCH_K, DISPATCH_EPOCHS, DISPATCH_SAVE = 4, 2, 6


def levers_argv(root, seed, out, anno, *extra):
    """Phase cli's command line on the levers' clips, `anno` their captions."""
    argv = cli_argv(root, seed, *extra)
    argv[argv.index("--anno") + 1] = str(root / anno)
    argv[argv.index("--out") + 1] = str(out)
    argv[argv.index("--out_samples") + 1] = str(out / "samples")
    return argv


def levers_data(root, seed):
    t0 = time.perf_counter()
    sents = generate_examples(root / "videos", root / "sent.pickle", num_examples=LEVERS_CLIPS,
                              frame_size=(64, 64), num_frames=16, seed=seed + 1,
                              num_channels=3)
    with open(root / "vocab.pickle", "wb") as f:
        pickle.dump(build_vocab([c for v in sents.values() for c in v]), f)
    with open(root / "sent_e2e.pickle", "wb") as f:
        pickle.dump(dict(list(sents.items())[:LEVERS_E2E_CLIPS]), f)
    print(f"phase levers: {LEVERS_CLIPS} clips of 16x64x64x3 in "
          f"{time.perf_counter() - t0:.2f} s")


def levers_end2end_sgd(root, seed):
    """Part a: --end2end --gen_steps 2, --end2end_d_only and --sgd, each
    LEVERS_STEPS steps and --resume for one, every step finite at the
    launches train_launches gives; the encoder's gradient reached through
    cuDNN's LSTM backward; steps timed alone; one --end2end --gen_steps 2
    step with the kernels against no_kernel() (compare_kernel_and_plain_cli_step's
    rule). Returns each run's launches and step ms."""
    out = {}
    for name, (flags, want) in LEVERS_RUNS.items():
        t0 = time.perf_counter()
        argv = levers_argv(root, seed, root / name, "sent_e2e.pickle", *flags)
        rec = run_cli(argv + ["--epochs", str(LEVERS_STEPS)], "levers", want, torch.float32)
        launches = counts()
        check(len(rec.steps) == LEVERS_STEPS, f"{name}: {len(rec.steps)} steps run")
        res = run_cli(argv + ["--epochs", "1", "--resume"], "levers", want, torch.float32)
        check([r["iteration"] for r in res.steps] == [LEVERS_STEPS],
              f"{name}: --resume ran {[r['iteration'] for r in res.steps]}")
        step = res.step
        if name.startswith("end2end"):
            txt = step.txt_params
            in_g = name == "end2end_gen2"
            check(step.gan.cond_encoder.training, f"{name}: the encoder is not in training mode")
            for opt, want_in in ((step.opt_d, True), (step.opt_g, in_g)):
                moved = [float(opt.state[p]["exp_avg"].abs().max()) > 0
                         for p in txt if p in opt.state]
                check(len(moved) == (len(txt) if want_in else 0)
                      and (not want_in or sum(moved) >= len(txt) - 2),
                      f"{name}: the encoder's moments in the optimizers: {len(moved)} held, "
                      f"{sum(moved)} nonzero of {len(txt)}")
            print(f"phase levers: {name}: the encoder's gradient reached "
                  f"{'both optimizers' if in_g else 'the D optimizer'} through cuDNN's "
                  f"LSTM backward")
        else:
            check(isinstance(step.opt_g, torch.optim.SGD), f"{name}: G's optimizer is "
                  f"{type(step.opt_g).__name__}")
        if name == "end2end_gen2":
            compare_kernel_and_plain_cli_step(step, res.batch, phase="levers")
        gp_ms, plain_ms = time_cli_steps(step, res.batch, n=6, phase=f"levers {name}")
        out[name] = {"launches": launches, "per_step": want, "gp_ms": gp_ms,
                     "plain_ms": plain_ms}
        print(f"phase levers: {name}: {time.perf_counter() - t0:.2f} s, launches per step "
              f"{want}")
    return out


def levers_device_data(seed, cond_root, cond_ms):
    """Part b: r9's float32 command line with --device_data on phase cond128's
    packed clips (4 steps), the cache's bytes on the card, steps timed beside
    phase cond128's host-loader ones, one step on an assembled batch against
    the step on host_batch of the same indices; then a cache of BIG_CACHE
    clips from --seed: its upload, assemble at batch 32, and the peak memory
    of one cond-128 GP step on it."""
    from txt2vid_tpu_torch.data import device_cache
    pairs = sum(len(v) for v in load_pickle(cond_root / "sent.pickle").values())
    epochs = -(-4 // max(pairs // COND128_BATCH, 1))
    argv = cond128_argv(cond_root, seed, out=cond_root / "levers_out")
    argv[argv.index("--epochs") + 1] = str(epochs)
    made = []
    from_dataset = device_cache.DeviceVideoData.from_dataset.__func__
    device_cache.DeviceVideoData.from_dataset = classmethod(
        lambda cls, *a, **k: made.append(from_dataset(cls, *a, **k)) or made[-1])
    want = train_launches(COND128_SCALES, remat_g=True)
    try:
        rec = run_cli(argv + ["--device_data"], "levers", want, torch.float32)
    finally:
        device_cache.DeviceVideoData.from_dataset = classmethod(from_dataset)
    launches = counts()
    (data,) = made
    check(len(rec.steps) == epochs * max(pairs // COND128_BATCH, 1), "device data steps")
    cap = data.captions.size * 8
    check(data.nbytes == data.videos.nbytes + 8 * data.num_pairs + cap,
          f"device cache bytes {data.nbytes}")
    check(data.device_arrays()["videos"].is_cuda, "the cache is not on the card")
    print(f"phase levers: device data: {data.num_pairs} pairs, {data.nbytes} bytes on the "
          f"card (clips {data.videos.nbytes}), {len(rec.steps)} steps at launches {want}")
    step = rec.step
    wrapped = device_cache.DeviceDataStep(step, data, COND128_BATCH, seed=seed)
    gp_ms, plain_ms = time_cli_steps(wrapped, {}, n=6, phase="levers device data")
    print(f"phase levers: device data GP / plain step {gp_ms:.2f} / {plain_ms:.2f} ms, "
          f"phase cond128's host loader {cond_ms[0]:.2f} / {cond_ms[1]:.2f} ms")

    # the same step on the assembled batch and on host_batch of its indices
    start = StateSnapshot(step)
    idx, phase = data.draw(seed, step.step, COND128_BATCH)
    runs = []
    for batch in (data.assemble(idx, phase),
                  next(train_gan.device_batches([data.host_batch(idx.numpy())],
                                                torch.device("cuda"), 0))):
        start.restore(step)
        m = {k: float(v) for k, v in step(batch).items()}
        runs.append((m, {n: step.opt_g.state[p]["exp_avg"].double().clone()
                         for n, p in step.gan.gen.named_parameters()}))
    start.restore(step)
    loss_err = max(abs(runs[0][0][k] - runs[1][0][k]) / abs(runs[1][0][k])
                   for k in ("loss_d", "loss_g"))
    scales = leaf_scales(runs[1][1])
    mom_err = max(float((runs[0][1][n] - r).abs().max()) / scales[n]
                  for n, r in runs[1][1].items())
    print(f"phase levers: a step on the assembled batch vs host_batch of the same indices: "
          f"losses rel diff {loss_err:.3g} (tol 1e-4), G's Adam first moments max|diff| / "
          f"leaf scale {mom_err:.3g} (tol 1e-3)")
    check(loss_err <= 1e-4 and mom_err <= 1e-3, "the device-data step disagrees")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = BIG_CACHE[0]
    vocab_len = len(load_pickle(cond_root / "vocab.pickle"))
    lens = rng.integers(3, 33, n).astype(np.int32)
    caps = rng.integers(1, vocab_len, (n, 32)).astype(np.int32)
    caps[np.arange(32)[None, :] >= lens[:, None]] = 0
    big = device_cache.DeviceVideoData(rng.integers(0, 256, BIG_CACHE, dtype=np.uint8),
                                       np.arange(n), caps, lens, num_frames=BIG_CACHE[1])
    made_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.device_arrays(torch.device("cuda"))
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    check(big.videos.nbytes == 4_194_304_000, f"the large cache holds {big.videos.nbytes}")
    idx, _ = big.draw(seed, 0, COND128_BATCH)
    asm_ms = cuda_ms(lambda: big.assemble(idx, 0))
    big_step = device_cache.DeviceDataStep(step, big, COND128_BATCH, seed=seed)
    while step.step % step.config.gp_every:
        step.step += 1
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = float(big_step({})["loss_d"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss), f"the GP step on the large cache: loss_d {loss}")
    print(f"phase levers: a {BIG_CACHE} uint8 cache ({big.videos.nbytes} bytes) made in "
          f"{made_s:.2f} s and uploaded in {up_s:.2f} s ({big.nbytes} bytes on the card); "
          f"assemble at batch {COND128_BATCH}: {asm_ms:.4f} ms; one cond-128 GP step on it: "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB; {held / 2**30:.3f} GiB held "
          f"before it)")
    big_bytes = big.nbytes
    del big, big_step
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": want, "bytes": data.nbytes, "gp_ms": gp_ms,
            "plain_ms": plain_ms, "big_bytes": big_bytes, "assemble_ms": asm_ms,
            "big_peak": peak, "step": step,
            "batch": data.assemble(*data.draw(seed, 0, COND128_BATCH))}


def chunk_saves(iterations, period, k):
    """The iterations the JAX trainer saves at (trainer.py:446-478): chunk
    ends with iteration % period < k, from `period` on, and the last."""
    out = [it for it in iterations if it % period < k and it >= period]
    return out + ([iterations[-1]] if iterations[-1] % period else [])


def levers_dispatch(root, seed):
    """Part c: phase cli's command line on LEVERS_CLIPS clips for
    DISPATCH_EPOCHS epochs with --steps_per_dispatch DISPATCH_K, against k =
    1 on the same batches, cuDNN held to deterministic algorithms: the final
    states bit for bit (or no further apart than a second k = 1 run from the
    first, twice over); the checkpoints at the iterations the JAX trainer
    picks; the EMA updated once per chunk with weight 1 - decay**k; one copy
    of the video per chunk, counted in the k-step run's profiler trace."""
    from txt2vid_tpu_torch.utils import profiling
    make_update = ema_mod.make_ema_update
    updates = []

    def recording(decay, k=1):
        update = make_update(decay, k)

        def run(avg, gen):
            name = next(iter(avg))
            before = avg[name].clone()
            out = update(avg, gen)
            param = dict(gen.named_parameters())[name].detach()
            want = before + (1 - decay ** k) * (param - before)
            updates.append((k, float((out[name] - want).abs().max())
                            / max(1.0, float(want.abs().max()))))
            return out
        return run

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ema_mod.make_ema_update = recording
    states, saved = {}, {}
    n_steps = DISPATCH_EPOCHS * LEVERS_CLIPS // bench.BATCH
    try:
        for label, k in (("k1", 1), (f"k{DISPATCH_K}", DISPATCH_K)):
            out = root / f"dispatch_{label}"
            argv = levers_argv(root, seed, out, "sent.pickle", "--epochs",
                               str(DISPATCH_EPOCHS), "--save_model_period",
                               str(DISPATCH_SAVE), "--steps_per_dispatch", str(k))
            updates.clear()
            t0 = time.perf_counter()
            if k > 1:
                with profiling.trace(str(root / "trace")):
                    rec = run_cli(argv, "levers", TRAIN_LAUNCHES, torch.float32)
            else:
                rec = run_cli(argv, "levers", TRAIN_LAUNCHES, torch.float32)
            run_s = time.perf_counter() - t0
            check(len(rec.steps) == n_steps, f"{label}: {len(rec.steps)} steps")
            states[label] = checkpoint.to_host(torch_state_to_jax(rec.step))
            saved[label] = sorted(int(p.name.split("_")[1]) for p in out.glob("iter_*")
                                  if p.suffix != ".ema")
            its = list(range(k, n_steps + 1, k))
            check(saved[label] == sorted(set(chunk_saves(its, DISPATCH_SAVE, k))),
                  f"{label}: checkpoints at {saved[label]}, the JAX trainer's rule gives "
                  f"{chunk_saves(its, DISPATCH_SAVE, k)}")
            check(len(updates) == n_steps // k and all(u[0] == k for u in updates)
                  and max(u[1] for u in updates) <= 1e-6,
                  f"{label}: EMA updates {updates}")
            print(f"phase levers: {label}: {n_steps} steps in {run_s:.2f} s, checkpoints at "
                  f"{saved[label]}, {len(updates)} EMA updates of weight 1 - 0.999**{k} "
                  f"(max|diff| / max(1, max|value|) {max(u[1] for u in updates):.3g}, tol "
                  f"1e-6)")
        fa, fb = dict(_flat(states["k1"])), dict(_flat(states[f"k{DISPATCH_K}"]))
        diff = max(float(np.abs(fa[n].astype(np.float64) - fb[n]).max()) for n in fa
                   if fa[n].dtype.kind == "f")
        spread = None
        if diff:
            out = root / "dispatch_k1_again"
            rec = run_cli(levers_argv(root, seed, out, "sent.pickle", "--epochs",
                                      str(DISPATCH_EPOCHS)), "levers", TRAIN_LAUNCHES,
                          torch.float32)
            fc = dict(_flat(checkpoint.to_host(torch_state_to_jax(rec.step))))
            spread = max(float(np.abs(fa[n].astype(np.float64) - fc[n]).max()) for n in fa
                         if fa[n].dtype.kind == "f")
        print(f"phase levers: k = {DISPATCH_K} against k = 1 after {n_steps} steps: "
              f"max|diff| {diff:.3g} over the state's leaves"
              + (f", a second k = 1 run {spread:.3g} from the first (tol 2x)" if diff else
                 " (bit for bit)"))
        check(diff == 0 or diff <= 2 * spread, "k-step dispatch strays from single steps")
    finally:
        ema_mod.make_ema_update = make_update
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    (trace,) = (root / "trace").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    video = bench.BATCH * 16 * 64 * 64 * 3
    sizes = [int(e.get("args", {}).get("bytes", -1)) for e in copies]
    n_chunks = n_steps // DISPATCH_K
    print(f"phase levers: the k = {DISPATCH_K} run's trace ({trace.stat().st_size} bytes): "
          f"{len(copies)} host-to-device copies, {sizes.count(DISPATCH_K * video)} of a "
          f"chunk's video ({DISPATCH_K * video} bytes), {sizes.count(video)} of one batch's")
    check(sizes.count(DISPATCH_K * video) == n_chunks and not sizes.count(video),
          f"copies of the video: {sizes}")
    return {"launches_k": counts(), "saved": saved, "diff": diff}


def levers_profile(step, batch):
    """Part d: utils.profiling.trace around one cond-128 GP step and one plain
    step: the top 10 device kernels of each, and format_memory_stats()."""
    from torch.autograd import DeviceType
    from txt2vid_tpu_torch.utils import profiling
    out = {}
    for gp in (True, False):
        while (step.step % step.config.gp_every == 0) != gp:
            step.step += 1
        with tempfile.TemporaryDirectory() as d:
            with profiling.trace(d) as prof:
                with profiling.step_annotation("cond128", step.step):
                    float(step(batch)["loss_d"])
            check(len(list(Path(d).glob("*.pt.trace.json"))) == 1, "no trace written")
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and not getattr(e, "is_user_annotation", False)),
                         key=lambda e: e.self_device_time_total, reverse=True)
        total = sum(e.self_device_time_total for e in kernels) / 1e3
        top = [(e.key, e.count, e.self_device_time_total / 1e3) for e in kernels[:10]]
        kind = "GP" if gp else "plain"
        print(f"phase levers: cond-128 {kind} step profiled: {total:.2f} device ms; top 10 "
              f"kernels (launches, ms): " + "; ".join(f"{k[:70]} ({c}, {ms:.2f})"
                                                       for k, c, ms in top))
        out[kind] = {"device_ms": total, "top": top}
    print(f"phase levers: {profiling.format_memory_stats()}")
    check(profiling.device_memory_stats(), "no device memory statistics on the card")
    return out


def phase_levers(seed, cond_root, cond_ms):
    """The training CLI's single-card levers (parts a-d, each timed); the
    clips of parts a and c in a directory of their own, removed after."""
    root = smoke_dir("levers_smoke_")
    out = {}
    try:
        levers_data(root, seed)
        for part, fn, args in (("a", levers_end2end_sgd, (root, seed)),
                               ("b", levers_device_data, (seed, cond_root, cond_ms)),
                               ("c", levers_dispatch, (root, seed))):
            t0 = time.perf_counter()
            out[part] = fn(*args)
            print(f"phase levers: part {part}: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        out["d"] = levers_profile(out["b"].pop("step"), out["b"].pop("batch"))
        print(f"phase levers: part d: {time.perf_counter() - t0:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


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
    base = None
    if args.baseline:
        base = load_baseline(args.baseline)
        print(f"phase compare: baseline {args.baseline} built in "
              f"{base._build.build_all():.2f} s")

    def kernel_records():
        fwd, (bwd, bwd_bf16) = phase_attention(args.seed), phase_attention_bwd(args.seed)
        return [fwd[0], *bwd], [fwd[1], *bwd_bf16]

    records, bf16_records = timed("kernels", kernel_records)
    timed("float64", phase_float64, args.seed, base)
    if base is not None:
        timed("compare", phase_compare, base, args.seed)
    serve_launches, serve_ms = timed("serve", phase_serve, args.seed)
    train, f32_bench = timed("train", phase_train, args.seed)
    cli_root, cond_root = smoke_dir("cli_smoke_"), smoke_dir("cond128_smoke_")
    try:
        cli, cli_ms = timed("cli", phase_cli, args.seed, cli_root)
        cond = timed("cond128", phase_cond128, args.seed, cond_root)
        evaluation = timed("eval", phase_eval, args.seed, cli_root, cond_root)
        shutil.rmtree(cli_root, ignore_errors=True)
        bf16 = timed("bf16", phase_bf16, args.seed, cond_root, cli_ms, serve_ms, f32_bench)
        levers = timed("levers", phase_levers, args.seed, cond_root, cond["step_ms"])
    finally:
        shutil.rmtree(cli_root, ignore_errors=True)
        shutil.rmtree(cond_root, ignore_errors=True)
    families = timed("families", phase_families, args.seed)
    timed("txt", phase_txt, args.seed)
    for r in records + bf16_records:
        r["tc_instructions"] = tc[r["name"]]
    records[0]["launches"] = serve_launches
    for kernel, r in (("attention_fwd", records[0]["train_shape"]),
                      *((r["name"], r) for r in records[1:])):
        r["launches"] = train[kernel]
        r["launches_per_step"] = TRAIN_LAUNCHES[kernel]
    for r in records:
        r["cli_launches"] = cli[r["name"]]
        r["cond128_launches"] = cond["launches"][r["name"]]
        r["cond128_launches_per_step"] = cond["per_step"][r["name"]]
        r["no_lstm_launches"] = families["launches"][r["name"]]
        r["no_lstm_launches_per_step"] = NO_LSTM_LAUNCHES[r["name"]]
    records[0]["cond128_serve_launches"] = cond["serve_launches"]
    # phase levers: each run's launches (its 3 steps, or 4 for device data
    # and 8 for the k-step dispatch) and per step
    for r in records:
        r["levers_launches"] = {
            **{run: v["launches"][r["name"]] for run, v in levers["a"].items()},
            "device_data": levers["b"]["launches"][r["name"]],
            "steps_per_dispatch": levers["c"]["launches_k"][r["name"]]}
        r["levers_launches_per_step"] = {
            **{run: v["per_step"][r["name"]] for run, v in levers["a"].items()},
            "device_data": levers["b"]["per_step"][r["name"]],
            "steps_per_dispatch": TRAIN_LAUNCHES[r["name"]]}
    # the evaluation CLIs' sampling and discriminator features (phase eval)
    records[0]["eval_launches"] = evaluation["launches"]
    records[0]["eval_shapes"] = evaluation["shapes"]
    # the bf16 instantiations: launches of phase bf16's 64-px command line (its
    # first run of 6 steps), of its cond-128 chunk and of its service
    for r in bf16_records:
        r["launches"] = bf16["cli"][r["name"]]
        r["launches_per_step"] = TRAIN_LAUNCHES[r["name"]]
        r["cond128_launches"] = bf16["cond128"][r["name"]]
    bf16_records[0]["serve_launches"] = bf16["serve"]
    check(all(r["launches"] for r in records + bf16_records),
          "a kernel was not launched on its main path")
    print(smi)
    print(json.dumps({"kernels": records + bf16_records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
