"""Checkpoint save/restore in the JAX package's format (counterpart of
txt2vid_tpu/utils/checkpoint.py:21-158).

A checkpoint is one msgpack file of the whole train state as flax writes it
(utils/msgpack.py): the GanTrainState tree of convert.torch_state_to_jax —
step, generator params and batch stats, discriminator and caption-encoder
params, both Adam states — named `iter_%d_lossG_%.4f_lossD_%.4f` as the
reference names its files. A file either package writes, the other restores.
Trees hold numpy arrays or torch tensors; tensors are written through the host,
a bfloat16 tensor as a msgpack.BFloat16Array (flax's bfloat16 leaf).
"""

import os
import threading
from pathlib import Path

import numpy as np
import torch

from txt2vid_tpu_torch.utils import msgpack
from txt2vid_tpu_torch.utils.misc import ensure_exists

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int32: np.int32, torch.int64: np.int64,
              torch.uint8: np.uint8, torch.bool: np.bool_}


def checkpoint_name(iteration: int, loss_g: float, loss_d: float) -> str:
    return f"iter_{iteration}_lossG_{loss_g:.4f}_lossD_{loss_d:.4f}"


def tree_map(fn, tree):
    """fn over the non-dict leaves of a tree of dicts (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _host_leaf(a):
    if not torch.is_tensor(a):
        return a
    a = a.detach().contiguous().to("cpu", copy=True)
    if a.dtype == torch.bfloat16:
        return msgpack.BFloat16Array.from_bits(a.view(torch.int16).numpy().view(np.uint16))
    return a.numpy()


def to_host(tree):
    """Every torch tensor leaf as a C-ordered numpy array of its own (a copy,
    also for a CPU tensor, so later in-place updates do not reach it; a
    bfloat16 tensor as a msgpack.BFloat16Array). The JAX layout's transposes
    are made on the tensor's device, so the copy to the host and the encoding
    move contiguous memory."""
    return tree_map(_host_leaf, tree)


def save_state(state, path) -> str:
    """Write a state tree to `path` (through `path`.tmp and os.replace)."""
    ensure_exists(str(Path(path).parent))
    data = msgpack.packb(to_host(state))
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return str(path)


def _snapshot_leaf(a):
    if torch.is_tensor(a):
        return a.detach().clone(memory_format=torch.contiguous_format)
    return a.copy() if isinstance(a, np.ndarray) else a


class AsyncCheckpointer:
    """Background-thread checkpointing with one slot: at most one save is in
    flight, and a save asked for while one runs waits in the slot, where a
    later one replaces it (latest wins). snapshot="device" clones the tensors
    on their device (the copy to the host overlaps training, at the cost of a
    second state in device memory until the save ends); snapshot="host" copies
    them to the host at once, leaving the thread the encoding and the file."""

    def __init__(self, save_fn=None, snapshot: str = "device"):
        if snapshot not in ("device", "host"):
            raise ValueError(f"snapshot {snapshot!r}")
        self._save_fn = save_fn or save_state
        self._snapshot = snapshot
        self._lock = threading.Lock()
        self._thread = None
        self._pending = None
        self.error = None

    def save(self, state, path) -> bool:
        """Returns True if the save started at once, False if it waits."""
        snap = to_host(state) if self._snapshot == "host" else tree_map(_snapshot_leaf, state)
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                if self._pending is not None:
                    from txt2vid_tpu_torch.utils.logging import warn
                    warn(f"checkpoint backlog: {self._pending[1]} superseded by {path}")
                self._pending = (snap, path)
                return False
            self._start_locked(snap, path)
            return True

    def _start_locked(self, state, path):
        def run():
            try:
                self._save_fn(state, path)
            except Exception as e:          # re-raised by wait()
                self.error = e
            finally:
                with self._lock:
                    if self._pending is not None:
                        nxt_state, nxt_path = self._pending
                        self._pending = None
                        self._start_locked(nxt_state, nxt_path)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until every started and waiting save has ended; raise the
        first error a save met."""
        while True:
            with self._lock:
                t = self._thread
                idle = (t is None or not t.is_alive()) and self._pending is None
            if idle:
                break
            if t is not None:
                t.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def _is_bf16(leaf):
    return isinstance(leaf, msgpack.BFloat16Array) or (
        torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16)


def _dtype_of(leaf):
    if torch.is_tensor(leaf):
        return np.dtype(_NP_DTYPES[leaf.dtype])
    return getattr(leaf, "dtype", None)


def _restore_like(template, state, path):
    if isinstance(template, dict):
        if not isinstance(state, dict):
            raise ValueError(f"checkpoint holds a leaf where the state has a tree at {path}")
        missing = [k for k in template if k not in state]
        if missing:
            raise ValueError(f"checkpoint lacks {missing} at {path}")
        return {k: _restore_like(v, state[k], f"{path}/{k}") for k, v in template.items()}
    if template is None:
        return state
    if isinstance(state, dict):
        raise ValueError(f"checkpoint holds a tree where the state has a leaf at {path}")
    shape = tuple(template.shape)
    if tuple(np.shape(state)) != shape:
        raise ValueError(f"checkpoint leaf {path} has shape {np.shape(state)}, the "
                         f"state {shape}")
    if _is_bf16(template):
        return msgpack.BFloat16Array.from_float32(state)
    arr = np.asarray(state)
    dtype = _dtype_of(template)
    return arr.astype(dtype) if dtype is not None and arr.dtype != dtype else arr


def restore_state(template, path):
    """The tree in `path`, in the structure of `template` (keys the template
    lacks are dropped, as flax's from_bytes does), each leaf cast to the
    template leaf's dtype (restore_state's rule: moment storage dtypes are run
    configuration, not state identity), so an f32 checkpoint resumes under a
    bf16-moment config and a bf16 one under f32; bfloat16 is rounded to
    nearest even, as jnp's astype rounds."""
    with open(path, "rb") as f:
        return _restore_like(template, msgpack.unpackb(f.read()), "")


def restore_txt_vars(path):
    """Caption-encoder variables from a txt-pretrain checkpoint ({"optim": ...,
    "txt": {"params": ...}}) or a bare variables file, without a template."""
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read())
    if isinstance(raw, dict) and "txt" in raw:
        raw = raw["txt"]
    if not (isinstance(raw, dict) and "params" in raw):
        raise ValueError(f"unrecognized sentence checkpoint structure in {path}")
    return raw


def latest_checkpoint(out_dir) -> str | None:
    """The iter_* checkpoint with the highest iteration in a directory; the
    `.ema` siblings (gan/ema.py) are not states and are skipped."""
    p = Path(out_dir)
    if not p.exists():
        return None
    cands = []
    for f in p.iterdir():
        if f.name.startswith("iter_") and not f.name.endswith((".ema", ".tmp")):
            try:
                cands.append((int(f.name.split("_")[1]), f))
            except (IndexError, ValueError):
                continue
    return str(max(cands)[1]) if cands else None
