"""Run setup: seeding, the device report and the multi-process setup
(counterpart of txt2vid_tpu/train/setup.py).

`maybe_init_distributed` starts torch.distributed: with --multihost
--coordinator host:port --num_processes n --process_id i through a tcp://
init, or from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), the counterpart of the JAX package's one process over many
devices. The backend is NCCL for a CUDA device and gloo otherwise; each rank
uses cuda:LOCAL_RANK (0 without it)."""

import os
import random

import numpy as np
import torch

from txt2vid_tpu_torch import resolve_device
from txt2vid_tpu_torch.utils import status


def set_seed(seed=None) -> int:
    """Seed Python's, numpy's and torch's generators; a random seed if None."""
    if seed is None:
        seed = random.randint(0, 2 ** 31 - 1)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return seed


def torchrun_env() -> bool:
    """Whether torchrun (or a launcher like it) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def maybe_init_distributed(args) -> bool:
    """Initialize the process group when --multihost is set or torchrun's
    environment is present; returns whether it did. A CUDA device becomes
    cuda:LOCAL_RANK in args.device."""
    import torch.distributed as dist
    multihost = getattr(args, "multihost", False)
    if not (multihost or torchrun_env()):
        return False
    device = resolve_device(getattr(args, "device", None))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        args.device = str(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if multihost and getattr(args, "coordinator", None):
        if args.num_processes is None or args.process_id is None:
            raise SystemExit("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_processes, rank=args.process_id)
    elif torchrun_env():
        dist.init_process_group(backend, init_method="env://")
    else:
        raise SystemExit("--multihost needs --coordinator host:port, --num_processes "
                         "and --process_id, or torchrun's environment (RANK, WORLD_SIZE)")
    status(f"multihost: process {dist.get_rank()}/{dist.get_world_size()} on {device} "
           f"({backend})")
    return True


def is_main_process() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, sample dumps, metric logs); always True without a process
    group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def add_multihost_args(parser):
    parser.add_argument('--multihost', action='store_true', default=False,
                        help='initialize torch.distributed (one process per card): '
                             'explicit --coordinator/--num_processes/--process_id, '
                             'or torchrun\'s environment. Each process feeds '
                             'batch_size/dp items; checkpoints and logs are written '
                             'by process 0 only.')
    parser.add_argument('--coordinator', type=str, default=None,
                        help='coordinator address host:port (a tcp:// init)')
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)


def setup(args):
    """(seed, device): seeds from --seed, the device from --device (CUDA unless
    the caller asks for another; raises without a GPU), reported with the
    card's name; --debug_nans turns on autograd's anomaly detection (the
    counterpart of jax_debug_nans). Float32 matmuls and convolutions run in
    float32, not TF32 (the JAX package's semantics; cuDNN takes TF32 by
    default), as bench.py and serve.py hold them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = set_seed(getattr(args, "seed", None))
    status(f"seed: {seed}")
    device = resolve_device(getattr(args, "device", None))
    if device.type == "cuda":
        status(f"{torch.cuda.device_count()} cuda device(s) available; using "
               f"{torch.cuda.get_device_name(device)}")
    else:
        status(f"running on {device}")
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    return seed, device
