"""One rank of tests/test_torch_parallel.py's multi-process runs.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel_worker.py JOBS.pkl OUT_DIR

joins a gloo group of n ranks on the CPU and runs each job of JOBS.pkl in
order: a train step of the port under a parallel.Mesh ("step", from a
train-state file and a global batch and global draws), steps that assemble
their batches from a device-resident dataset ("device_steps", through
DeviceDataStep), or ring attention over an sp group ("ring"). Writes
OUT_DIR/rank{r}.pkl: per job its metrics, the gathered train state as the
JAX tree (numpy), the shapes of the state at rest and the collectives the
step issued, or the ring's output and gradients. Imports torch and the port
only.
"""

import os
import pickle
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from txt2vid_tpu_torch.convert import jax_state_to_torch, torch_state_to_jax  # noqa: E402
from txt2vid_tpu_torch.gan import losses as port_losses  # noqa: E402
from txt2vid_tpu_torch.gan.cond_gan import CondGan  # noqa: E402
from txt2vid_tpu_torch.gan.train_step import (Draws, TrainConfig, adam,  # noqa: E402
                                              build_train_step, optimizer_params)
from txt2vid_tpu_torch.models import tganv2  # noqa: E402
from txt2vid_tpu_torch.models.txt import Seq2Seq  # noqa: E402
from txt2vid_tpu_torch.utils.checkpoint import restore_state, save_state, to_host  # noqa: E402


def build_step(job, mesh=None):
    """The port TrainStep of a step job, its state read from job["state"]."""
    gen = tganv2.MultiScaleGen(**job["gen"], with_non_local=True)
    disc = tganv2.MultiScaleDiscrim(**job["disc"])
    gan = CondGan(gen, Seq2Seq(**job["enc"]), discrims=[disc])
    cfg = TrainConfig(**job["config"])
    g_params, d_params = optimizer_params(gan, cfg)
    step = build_train_step(gan, getattr(port_losses, job["loss"])(), adam(g_params, 2e-4),
                            adam(d_params, 2e-4), cfg, mesh=mesh)
    jax_state_to_torch(restore_state(torch_state_to_jax(step), job["state"]), step)
    return step


def draws_of(d):
    """Draws from their numpy form (every array global)."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return Draws(t(d["z"]), list(d["pyramid"]), list(d["gen"]), [t(d["perm"]).long()],
                 None if d.get("alphas") is None else [[t(a) for a in d["alphas"]]])


def batch_of(b):
    return {"video": torch.from_numpy(b["video"]),
            "captions": torch.from_numpy(b["captions"]).long(),
            "lengths": torch.from_numpy(b["lengths"])}


def run_step(job):
    from txt2vid_tpu_torch.parallel import Mesh, dp_slice
    from txt2vid_tpu_torch.parallel.collectives import COUNTS, reset_counts
    mesh = Mesh(**job["mesh"])
    reset_counts()
    step = build_step(job, mesh)
    mesh.shard_state(step)
    at_rest = {f"{i}.{n}": tuple(p.shape)
               for i, m in enumerate([step.gan.gen, *step.gan.discrims])
               for n, p in m.named_parameters()}
    batch = dp_slice(job["batch"], mesh.dp_index, mesh.dp)
    metrics = step(batch_of(batch), draws_of(job["draws"]))
    with mesh.full_state():
        tree = to_host(torch_state_to_jax(step))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "state": tree,
            "at_rest": at_rest, "local_batch": len(batch["video"]),
            "collectives": {f"{b}/{op}": n for (b, op), n in COUNTS.items()},
            "coords": (mesh.dp_index, mesh.sp_index, mesh.fsdp_index)}


def run_device_steps(job):
    """job["steps"] steps of DeviceDataStep over job["data"] (the
    DeviceVideoData's arguments) at global batch job["batch_size"], under a
    Mesh of job["mesh"], or on one process when it is None; the state after
    each step (with job["save_to"], rank 0 writes it to save_to/step{s}).
    With job["loader"] the same steps take the host batches of the same
    draws instead, this rank's rows of each cut by dp_slice and copied as
    the loader's are (train.gan.device_batches)."""
    import contextlib
    from txt2vid_tpu_torch.data.device_cache import DeviceDataStep, DeviceVideoData
    from txt2vid_tpu_torch.parallel import dp_slice
    from txt2vid_tpu_torch.train.gan import device_batches
    mesh = None
    if job["mesh"] is not None:
        from txt2vid_tpu_torch.parallel import Mesh
        mesh = Mesh(**job["mesh"])
    step = build_step(job, mesh)
    if mesh is not None:
        mesh.shard_state(step)
    data = DeviceVideoData(**job["data"])
    data.device_arrays("cpu")
    wrapped = DeviceDataStep(step, data, job["batch_size"], seed=job["data_seed"])
    local = len(wrapped.batch()["video"])

    def loader_batch():
        idx, _ = data.draw(job["data_seed"], step.step, job["batch_size"])
        rows = dp_slice(data.host_batch(idx.numpy()), *((mesh.dp_index, mesh.dp) if mesh
                                                        else (0, 1)))
        return next(device_batches([rows], torch.device("cpu"), 0))

    metrics, states = [], []
    for s in range(job["steps"]):
        out = step(loader_batch()) if job.get("loader") else wrapped({})
        metrics.append({k: float(v) for k, v in out.items()})
        with mesh.full_state() if mesh is not None else contextlib.nullcontext():
            states.append(to_host(torch_state_to_jax(step)))
            if job.get("save_to") and (mesh is None or mesh.rank == 0):
                save_state(torch_state_to_jax(step), Path(job["save_to"]) / f"step{s}")
    return {"metrics": metrics, "states": states, "state": states[-1], "local_batch": local,
            "coords": None if mesh is None else (mesh.dp_index, mesh.sp_index, mesh.fsdp_index)}


def run_ring(job):
    from txt2vid_tpu_torch.ops.ring_attention import ring_attention
    from txt2vid_tpu_torch.parallel import Mesh
    mesh = Mesh(sp=job["sp"])
    theta, phi, g = (torch.from_numpy(job[k]).requires_grad_() for k in ("theta", "phi", "g"))
    o = ring_attention(theta, phi, g, mesh.sp_ring)
    o.backward(torch.from_numpy(job["do"]))
    return {"o": o.detach().numpy(), "grads": [t.grad.numpy() for t in (theta, phi, g)]}


def main():
    jobs_path, out_dir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://", timeout=timedelta(seconds=100))
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    out = []
    try:
        for job in jobs:
            out.append({"step": run_step, "device_steps": run_device_steps,
                        "ring": run_ring}[job["kind"]](job))
    finally:
        dist.destroy_process_group()
    with open(out_dir / f"rank{os.environ['RANK']}.pkl", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
