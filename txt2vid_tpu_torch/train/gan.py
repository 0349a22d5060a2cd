"""GAN training CLI of the port (counterpart of txt2vid_tpu/train/gan.py:54-465):
the JAX CLI's flag surface and defaults, components built by reflection
(config.py, which maps `txt2vid_tpu.*` and `txt2vid.*` specs onto the port),
checkpoints in the JAX package's format.

Example (conditional TGANv2, scripts/run_tganv2_cond.sh with the module name
changed, plus the regularization of scripts/r9_session.sh):
  python -m txt2vid_tpu_torch.train.gan \\
      --G txt2vid_tpu.models.tganv2_cond.MultiScaleGen \\
      --D txt2vid_tpu.models.tganv2_cond.MultiScaleDiscrim \\
      --sent txt2vid_tpu.models.txt.Seq2Seq \\
      --data config/synth.json --anno sent.pickle --vocab vocab.pickle \\
      --frame_sizes 8 16 32 64 --subsample_input --num_channels 3 \\
      --D_loss txt2vid_tpu.gan.losses.RSGANLoss \\
      --G_lr 0.0002 --D_lr 0.0002 --G_beta2 0.999 --D_beta2 0.999 \\
      --gp_lambda 0.5 --gp_every 2 --clip_grad 100 --g_ema 0.999 --batch_size 40

It runs on CUDA unless --device names another device (the tests pass
--device cpu). --weights, --resume and --sent_weights read checkpoints the
JAX package wrote, and the port's checkpoints open in the JAX package. A
NanAbort exits with code 42.

Across cards (train/gan.py:55-68,144-153,239-253), one process per card:
--multihost --coordinator host:port --num_processes n --process_id i, or
torchrun's environment (`torchrun --nproc_per_node n -m
txt2vid_tpu_torch.train.gan ...`), starts torch.distributed (NCCL; gloo on
the CPU). The world is a (dp, sp, fsdp) mesh (parallel/mesh.py): --sp
splits the non-local attention's tokens over a ring, --fsdp shards the
state at rest, and dp is what is left. --batch_size is the global batch;
each dp rank feeds batch_size / dp items of a ShardedView (ranks of one dp
index feed the same ones). Only rank 0 writes checkpoints and the metrics
writer, and in-loop sample dumps are off at a world size above 1. The JAX
CLI's refusals stay: --test, --device_data and --fsdp > 1 with --multihost
exit with its messages, and --test at a world size above 1 exits. A world
size that sp * fsdp does not divide raises, --sp 2 on one process among
them. --device_data across ranks uploads the whole dataset to every rank's
card and each rank assembles its dp rows of the global batch's draw
(data/device_cache.py); --steps_per_dispatch k across ranks stacks k of the
rank's batches, its rows of global batches i to i + k - 1 (JAX's
P(None, "dp")), and runs them as k steps, each with the collectives of one.

The single-card levers, as the JAX CLI has them (train/gan.py:101-105,
160-169, 253-340): --sgd trains both sides with optax.sgd's momentum SGD
(momentum --G_beta1 / --D_beta1); --end2end trains the caption encoder in
both optimizers, --end2end_d_only in the D optimizer alone; --gen_steps N
runs N G updates per step; --device_data uploads a packed dataset to the
card once and assembles each step's batch there (data/device_cache.py; not
with --img_model or --steps_per_dispatch > 1); --steps_per_dispatch k runs
k steps on each chunk of k batches, which reaches the card in one copy
(gan/trainer.py says how the iterations, periods and the EMA count them).

bfloat16, as the JAX CLI has it (train/gan.py:88-124,189-190): --bf16 builds
G and D with dtype bf16 (float32 parameters, per-use casts; the caption
encoder stays float32) and stores Adam's first moment in bf16; --bf16_nu
stores the second moment in bf16 as well (ops/optim.py); --bf16_params runs
every forward and backward of the step from one bf16 copy of the parameters
(TrainConfig.compute_dtype). The checkpoints hold the moments in their
storage dtype, as flax writes them, and restore across storage dtypes.

Every model family the JAX CLI trains: TGANv2 (with or without its
ConvLSTM, `no_lstm`), TCWYT with its three discriminators and the --M sample
mapping (scripts/run.sh), TGAN, and the image GAN (scripts/run_tgan.sh:
--img_model, whose batches are each clip's first frame, `video[:, 0]`,
unless --data_is_imgs says the dataset yields images, as
config/cifar10.json's does). --D_names name the discriminators and
--D_lambdas weight their losses. M is built with the model kwargs, from the
seed, and stays frozen; its variables are in the checkpoint (`m_vars`).
"""

import argparse
import json
import random
import sys
from collections import deque

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.config import create_object
from txt2vid_tpu_torch.convert import jax_state_to_torch, load_encoder_vars, torch_state_to_jax
from txt2vid_tpu_torch.data import ShardedView, get_loader, load_pickle
from txt2vid_tpu_torch.gan import trainer
from txt2vid_tpu_torch.gan.cond_gan import CondGan
from txt2vid_tpu_torch.gan.losses import MixedGanLoss
from txt2vid_tpu_torch.gan.train_step import (ChunkStep, TrainConfig, adam, build_train_step,
                                              optimizer_params, sgd)
from txt2vid_tpu_torch.ops.initializers import init_from_seed
from txt2vid_tpu_torch.train.setup import add_multihost_args, maybe_init_distributed, setup
from txt2vid_tpu_torch.utils import count_params, profiling, status, warn
from txt2vid_tpu_torch.utils.checkpoint import (latest_checkpoint, restore_state,
                                                restore_txt_vars)

def check_multihost_flags(args):
    """The JAX CLI's refusals under --multihost, with its messages
    (train/gan.py:56-68)."""
    if not args.multihost:
        return
    if args.test:
        raise SystemExit("--test sampling is single-process; run it "
                         "without --multihost on one host")
    if args.device_data:
        raise SystemExit("--device_data + --multihost is not supported "
                         "(the HBM-resident cache is per-process); use "
                         "the host loader path")
    if args.fsdp > 1:
        raise SystemExit("--fsdp + --multihost checkpointing needs a "
                         "distributed checkpoint format (state shards are "
                         "not process-addressable); use dp/sp axes across "
                         "hosts and fsdp only single-host for now")


def check_world_flags(args, world: int):
    """--test's refusal at a world size above 1."""
    if world > 1 and args.test:
        raise SystemExit("--test sampling is single-process; run it in one process")


def check_flags(args):
    k = max(args.steps_per_dispatch, 1)
    if args.clip_grad_split and args.discrim_steps != 1:
        raise ValueError("--clip_grad_split requires discrim_steps == 1")
    if args.clip_grad_split and k > 1:
        raise ValueError("--clip_grad_split requires --steps_per_dispatch 1")
    if args.device_data and not args.test:
        if args.img_model:
            raise ValueError("--device_data supports the video path, not --img_model")
        if k > 1:
            raise ValueError("--device_data implies --steps_per_dispatch 1")


def _seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def device_batches(loader, device, depth: int):
    """Host batches -> device batches (video and captions on `device`, lengths
    on the host), copied `depth` batches ahead of the consumer."""
    cuda = device.type == "cuda"

    def put(b):
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "lengths":
                out[k] = t
                continue
            if k == "captions":
                t = t.long()
            out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t.to(device)
        return out

    q = deque()
    for b in loader:
        q.append(put(b))
        if len(q) > max(depth, 0):
            yield q.popleft()
    while q:
        yield q.popleft()


def stack_batches(batches, k: int):
    """Chunks of k consecutive batches, each key stacked (k, B, ...); a batch
    whose leading size differs from the first's is dropped with a message,
    and so is a trailing group of fewer than k (parallel/mesh.py:179-198)."""
    group, expect = [], None
    for b in batches:
        lead = len(next(iter(b.values())))
        if expect is None:
            expect = lead
        if lead != expect:
            status(f"dropping a ragged batch (leading size {lead} != {expect})")
            continue
        group.append(b)
        if len(group) == k:
            yield {key: np.stack([g[key] for g in group]) for key in group[0]}
            group = []


def first_frames(batches):
    """--img_model on a video dataset: each clip's first frame as the image
    (train/gan.py:197-200,301-305)."""
    for b in batches:
        yield dict(b, video=b["video"][:, 0])


class LoaderAdapter:
    """The trainer's dataset: the loader's batches (each clip's first frame
    under first_frame), stacked in chunks of k, copied to the device `depth`
    items ahead. Across ranks the loader reads the rank's ShardedView, so a
    chunk holds its rows of k consecutive global batches (JAX's
    P(None, "dp"))."""

    def __init__(self, loader, device, depth, first_frame=False, k=1):
        self.loader, self.device, self.depth = loader, device, depth
        self.first_frame, self.k = first_frame, k

    def __iter__(self):
        batches = self.loader if not self.first_frame else first_frames(self.loader)
        if self.k > 1:
            batches = stack_batches(batches, self.k)
        return device_batches(batches, self.device, self.depth)

    def __len__(self):
        return len(self.loader) // self.k


def main(args):
    check_flags(args)
    check_multihost_flags(args)
    if not maybe_init_distributed(args):
        return _main(args, None)
    import torch.distributed as dist
    try:
        return _main(args, dist.get_world_size())
    finally:
        dist.destroy_process_group()


def _make_mesh(args, world):
    """The parallel.Mesh of a process group (world) or of --sp / --fsdp
    above 1 (which raises on one process); else None."""
    if world is None and args.sp * args.fsdp == 1:
        return None
    if args.fsdp > 1 and args.clip_grad_split:
        raise ValueError("--clip_grad_split with fsdp state shardings is not supported")
    from txt2vid_tpu_torch.parallel import Mesh
    mesh = Mesh(sp=args.sp, fsdp=args.fsdp)
    status(f"mesh: {mesh}")
    return mesh


def _broadcast_seed(args):
    """Every rank draws from rank 0's --seed (a random one when not given)."""
    from txt2vid_tpu_torch.parallel.collectives import broadcast_
    seed = random.randint(0, 2 ** 31 - 1) if args.seed is None else args.seed
    args.seed = int(broadcast_(torch.tensor([seed], dtype=torch.int64,
                                            device=resolve_device(args.device)))[0])


def _main(args, world):
    if world is not None:
        check_world_flags(args, world)
        _broadcast_seed(args)
    mesh = _make_mesh(args, world)
    seed, device = setup(args)

    vocab = None
    if args.vocab:
        status(f"Loading vocab from {args.vocab}")
        vocab = load_pickle(args.vocab)

    with profiling.span("setup.models", always=True):
        txt_encoder, cond_dim = None, 0
        if not args.dont_use_sent and vocab is not None:
            txt_encoder = create_object(args.sent or "txt2vid_tpu_torch.models.txt.Seq2Seq",
                                        vocab_size=len(vocab), init_method=args.init_method)
            cond_dim = txt_encoder.encoding_size
            status(f"Sentence encode size = {cond_dim}")
        else:
            status("Not using sentence encoder")

        model_kwargs = dict(init_method=args.init_method)
        if args.bf16:
            status("Using bfloat16 compute")
            model_kwargs["dtype"] = torch.bfloat16
        gen = create_object(args.G, cond_dim=cond_dim, **model_kwargs)
        discrims = [create_object(d, cond_dim=cond_dim, **model_kwargs) for d in args.D]
        sample_mapping = create_object(args.M, **model_kwargs) if args.M else None
        for k, m in enumerate([gen, *discrims, txt_encoder, sample_mapping]):
            if m is not None:
                init_from_seed(m, _seed(seed, k)).to(device)
        gan = CondGan(gen, txt_encoder, discrims=discrims, discrim_lambdas=args.D_lambdas,
                      sample_mapping=sample_mapping, discrim_names=args.D_names)

        config = TrainConfig(
            frame_sizes=tuple(args.frame_sizes),
            subsample_input=args.subsample_input,
            discrim_steps=args.discrim_steps,
            gen_steps=args.gen_steps,
            gp_lambda=args.gp_lambda,
            gp_every=args.gp_every,
            gp_quarantine=args.gp_quarantine,
            end2end=args.end2end or args.end2end_d_only,
            end2end_txt_in_g=not args.end2end_d_only,
            mean_discrim_loss=not args.no_mean_discrim_loss,
            mean_gen_loss=not args.no_mean_gen_loss,
            img_model=args.img_model,
            latent_size=gen.latent_size,
            shared_gen_fwd=args.shared_gen_fwd,
            clip_grad=args.clip_grad or 0.0,
            compute_dtype=torch.bfloat16 if args.bf16_params else None,
        )
        # end2end: the encoder's parameters follow G's and D's in their optimizers
        g_params, d_params = optimizer_params(gan, config)
        if args.sgd:
            status("Using SGD")
            opt_d = sgd(d_params, args.D_lr, args.D_beta1)
            opt_g = sgd(g_params, args.G_lr, args.G_beta1)
        else:
            status("Using Adam")
            # --bf16 stores the first moment in bf16, --bf16_nu the second; the
            # update's arithmetic stays float32
            storage = dict(mu_dtype=torch.bfloat16 if args.bf16 else None,
                           nu_dtype=torch.bfloat16 if args.bf16_nu else None)
            opt_d = adam(d_params, args.D_lr, args.D_beta1, args.D_beta2, **storage)
            opt_g = adam(g_params, args.G_lr, args.G_beta1, args.G_beta2, **storage)
        if args.clip_grad:
            status(f"Clipping gradients to global norm {args.clip_grad}")

    with profiling.span("setup.data", always=True):
        status(f"Loading data from {args.data}")
        dset = create_object(args.data, vocab=vocab, anno=args.anno,
                             frame_size=args.frame_sizes[-1], num_channels=args.num_channels,
                             random_frames=args.random_frames, normalize=not args.uint8_input)
        local_bs, full_dset = args.batch_size, dset
        if mesh is not None:
            if args.batch_size % mesh.dp:
                raise SystemExit(f"--batch_size {args.batch_size} must divide by the {mesh.dp} "
                                 "data-parallel ranks")
            local_bs = args.batch_size // mesh.dp
            dset = ShardedView(dset, mesh.dp_index, mesh.dp)
            status(f"multihost data: process {mesh.rank} feeds {len(dset)} items, "
                   f"{local_bs}/{args.batch_size} of each global batch")
        loader = get_loader(dset=dset, batch_size=local_bs, val=args.test,
                            num_workers=args.workers, seed=seed)
        ddata = None
        if args.device_data and not args.test:
            if not hasattr(dset, "reader"):
                raise ValueError("--device_data needs a packed dataset "
                                 "(txt2vid_tpu.data.packed.packed_dataset)")
            from txt2vid_tpu_torch.data.device_cache import DeviceVideoData
            status("Building the device-resident dataset (one upload)")
            # the whole dataset on every rank's card, as JAX replicates it
            ddata = DeviceVideoData.from_dataset(full_dset, random_phase=bool(args.random_frames))
            ddata.device_arrays(device)
            status(f"device dataset: {ddata.num_pairs} pairs, {ddata.nbytes} bytes per card")

    if args.G_loss is None:
        args.G_loss = args.D_loss
    losses = MixedGanLoss(g_loss=create_object(args.G_loss), d_loss=create_object(args.D_loss))
    step = build_train_step(gan, losses, opt_g, opt_d, config, seed=seed, mesh=mesh)

    with profiling.span("setup.models", always=True):
        if args.resume and not args.weights:
            args.weights = latest_checkpoint(args.out)
            if args.weights:
                status(f"Auto-resuming from {args.weights}")
        if args.weights:
            status(f"Loading weights from {args.weights}")
            jax_state_to_torch(restore_state(torch_state_to_jax(step), args.weights), step)

        ema = None
        if args.g_ema and args.weights:
            from txt2vid_tpu_torch.gan.ema import init_ema, load_ema
            ema = load_ema(args.weights, init_ema(gen), gen)
            if ema is not None:
                status(f"Restored generator EMA from {args.weights}.ema")

        if args.sent_weights:
            status(f"Loading pre-trained sentence model from {args.sent_weights}")
            with torch.no_grad():
                load_encoder_vars(txt_encoder, restore_txt_vars(args.sent_weights))

        if mesh is not None and mesh.fsdp > 1 and not args.test:
            # the state (and the EMA) at rest as this rank's shards, from here on
            if args.g_ema and ema is None:
                from txt2vid_tpu_torch.gan.ema import init_ema
                ema = init_ema(gen)
            mesh.shard_state(step, ema)

    n_params = sum(count_params(m) for m in [gen, *discrims, txt_encoder] if m is not None)
    status("GAN has %d parameters (~%.2f * 10^8)" % (n_params, n_params / 1e8))
    status(f"Dataset len= {len(loader) * args.batch_size} ({len(loader)} batches)")

    first_frame = args.img_model and not args.data_is_imgs
    if args.test:
        # sampling takes plain batches
        trainer.test(gan=gan, num_samples=args.num_samples,
                     dataset=LoaderAdapter(loader, device, args.prefetch, first_frame),
                     params=args, vocab=vocab, ema=ema)
        return
    # the trainer counts iterations and periods by it
    k = args.steps_per_dispatch = max(args.steps_per_dispatch, 1)
    if ddata is not None:
        from txt2vid_tpu_torch.data.device_cache import DeviceDataStep, DeviceEpochIterator
        step = DeviceDataStep(step, ddata, args.batch_size, seed=seed)
        # the real-sample grids' host batches, each copied to the device once
        # where the grids are drawn (one process)
        dataset = DeviceEpochIterator(
            ddata, args.batch_size, seed=seed,
            put=(lambda b: next(device_batches([b], device, 0))) if (world or 1) == 1 else None)
    else:
        dataset = LoaderAdapter(loader, device, args.prefetch, first_frame, k=k)
    if k > 1:
        for name in ("save_model_period", "log_period", "save_example_period"):
            period = getattr(args, name, 0)
            if period and period % k:
                warn(f"--{name} {period} is not a multiple of --steps_per_dispatch {k}: "
                     f"actions fire at the chunk-end iteration after the boundary (e.g. "
                     f"period {period} saves at iter {(period // k + 1) * k})")
        step = ChunkStep(step, k)
    try:
        trainer.train(gan=gan, train_step=step, num_epoch=args.epochs, dataset=dataset,
                      params=args, vocab=vocab, seed=seed, ema=ema)
    except trainer.NanAbort as e:
        status(f"NAN_ABORT: {e} — exiting 42 (resume from the last checkpoint with a "
               "fresh --seed)")
        sys.exit(42)
    if mesh is not None:
        from txt2vid_tpu_torch.parallel.collectives import COUNTS
        status("collectives: " + json.dumps({f"{b}/{op}": n for (b, op), n in
                                             sorted(COUNTS.items())}))


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    trainer.add_params_to_parser(parser)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; default cuda (raises without a GPU)')
    add_multihost_args(parser)
    parser.add_argument('--test', action='store_true')
    parser.add_argument('--num_samples', type=int, default=1)
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--workers', type=int, default=2)
    parser.add_argument('--prefetch', type=int, default=3,
                        help='batches copied to the device ahead of the train step')
    parser.add_argument('--device_data', action='store_true', default=False,
                        help='upload the packed dataset to the device once and '
                             'assemble each step\'s batch there')
    parser.add_argument('--steps_per_dispatch', type=int, default=1,
                        help='run k train steps on each chunk of k batches, copied to '
                             'the device in one transfer (use periods divisible by k)')
    parser.add_argument('--frame_sizes', type=int, nargs='+', default=[64])
    parser.add_argument('--num_channels', type=int, default=1)
    parser.add_argument('--random_frames', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--init_method', type=str, default='xavier')
    parser.add_argument('--G_loss', type=str, default=None)
    parser.add_argument('--G_lr', type=float, default=0.0001)
    parser.add_argument('--G_beta1', type=float, default=0.5)
    parser.add_argument('--G_beta2', type=float, default=0.9)
    parser.add_argument('--D_loss', type=str,
                        default='txt2vid_tpu_torch.gan.losses.VanillaGanLoss')
    parser.add_argument('--D_lr', type=float, default=0.0001)
    parser.add_argument('--D_beta1', type=float, default=0.5)
    parser.add_argument('--D_beta2', type=float, default=0.9)
    parser.add_argument('--weights', type=str, default=None)
    parser.add_argument('--resume', action='store_true', default=False,
                        help='resume from the latest checkpoint in --out')
    parser.add_argument('--sent_weights', type=str, default=None)
    parser.add_argument('--data', type=str, required=True)
    parser.add_argument('--anno', type=str, default=None)
    parser.add_argument('--vocab', type=str, default=None)
    parser.add_argument('--M', type=str, default=None,
                        help='sample mapping (e.g. txt2vid_tpu.models.tcwyt.FrameMap): '
                             'a frozen feature extractor whose features the '
                             'discriminators read as xbar')
    parser.add_argument('--G', type=str, required=True)
    parser.add_argument('--D', type=str, nargs='+', required=True)
    parser.add_argument('--D_names', type=str, nargs='+', default=None)
    parser.add_argument('--D_lambdas', type=float, nargs='+', default=None)
    parser.add_argument('--sent', type=str, default=None)
    parser.add_argument('--dont_use_sent', action='store_true', default=False)
    parser.add_argument('--end2end', action='store_true', default=False,
                        help='train the caption encoder in both optimizers')
    parser.add_argument('--end2end_d_only', action='store_true', default=False,
                        help='train the caption encoder in the D optimizer alone')
    parser.add_argument('--sgd', action='store_true', default=False,
                        help='momentum SGD (momentum = beta1) in place of Adam')
    parser.add_argument('--clip_grad', type=float, default=None,
                        help='global gradient-norm clip for both optimizers')
    parser.add_argument('--clip_grad_split', action='store_true', default=False,
                        help='runs the same in-step clip: the JAX package splits the '
                             'clip into separate programs only to dodge a TPU '
                             'miscompile, and its tests pin the two equal')
    parser.add_argument('--bf16_nu', action='store_true', default=False,
                        help='store the second Adam moment in bfloat16 as well '
                             '(the update math stays float32)')
    parser.add_argument('--bf16', action='store_true', default=False,
                        help='bfloat16 compute dtype for G and D (parameters stay '
                             'float32) and a bfloat16 first Adam moment')
    parser.add_argument('--bf16_params', action='store_true', default=False,
                        help='one bfloat16 copy of the G and D parameters per step, '
                             'which every forward and backward reads (stored '
                             'parameters and the update stay float32)')
    parser.add_argument('--shared_gen_fwd', action='store_true', default=False,
                        help='accepted: with gen_steps 1 outside end2end the port always '
                             'runs one generator forward per step, the same computation')
    parser.add_argument('--sp', type=int, default=1,
                        help='sequence-parallel ranks: the non-local attention\'s tokens '
                             'ring-split over them; world = dp * sp * fsdp')
    parser.add_argument('--fsdp', type=int, default=1,
                        help='fsdp ranks: parameters, optimizer moments and BatchNorm '
                             'statistics sharded at rest over them; world = dp * sp * fsdp')
    parser.add_argument('--uint8_input', action='store_true', default=True,
                        help='ship video batches as uint8, normalize on the device')
    parser.add_argument('--no_uint8_input', dest='uint8_input', action='store_false')
    parser.add_argument('--debug', action='store_true', default=False)
    parser.add_argument('--debug_nans', action='store_true', default=False,
                        help="autograd's anomaly detection")
    parser.add_argument('--cuda', action='store_true', default=False, help=argparse.SUPPRESS)
    parser.add_argument('--ngpu', type=int, default=1, help=argparse.SUPPRESS)
    parser.add_argument('--opt_level', type=str, default='O2', help=argparse.SUPPRESS)
    return parser


def cli(argv=None):
    main(build_parser().parse_args(argv))


if __name__ == '__main__':
    cli()
