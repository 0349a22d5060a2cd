"""Build and load the port's CUDA kernels.

Each kernel is one source under `txt2vid_tpu_torch/csrc/` with a plain C
interface; headers shared between sources (`csrc/*.cuh`) sit beside them. It
is compiled on first use with `nvcc` for `sm_90a` into a shared library under
`build/txt2vid_tpu_torch/` at the checkout's root, keyed by a hash of its
source, the headers and the flags, and loaded with ctypes. Nothing here runs at
import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from txt2vid_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "txt2vid_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> its source under csrc/
SOURCES = {"attention_fwd": "attention_fwd.cu", "attention_bwd": "attention_bwd.cu",
           "conv3x3": "conv3x3.cu"}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc's output (registers, spills)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built with "
                           "the CUDA toolkit on the machine that has the GPU")
    return nvcc


def library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all(names=None) -> float:
    """Compile every kernel that is not built yet, one nvcc each, all started
    together. Returns the wall seconds taken. Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed, under the always span
    `setup.kernels`."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("setup.kernels", always=True):
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
