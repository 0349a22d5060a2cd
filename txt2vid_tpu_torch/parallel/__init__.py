"""The port's parallel layer (counterpart of txt2vid_tpu/parallel/): the
(dp, sp, fsdp) mesh over torch.distributed process groups, the global-batch
semantics of the train step across ranks, ZeRO-3 state sharding and the
counted collectives. Imported only when a process group exists or a mesh
is asked for; without one every module of the port takes its one-device
path."""

from txt2vid_tpu_torch.parallel.mesh import GlobalBatch, Mesh, ShardedState, dp_slice, fsdp_spec

__all__ = ["GlobalBatch", "Mesh", "ShardedState", "dp_slice", "fsdp_spec"]
