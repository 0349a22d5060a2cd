"""PyTorch + CUDA port of txt2vid_tpu for NVIDIA Hopper (H100).

Laid out like the JAX package (ops/, models/, gan/, data/, serve.py) and held
against it by the tests under tests/test_torch_*.py. Imports torch and numpy,
never JAX and nothing of txt2vid_tpu. Entry points run on CUDA unless the caller
passes device="cpu". Importing the package imports no torch, so the host
tools that need none (the data ingest CLIs) start without it.
"""


def resolve_device(device=None):
    """`device` as a torch.device; None means CUDA, and raises without a GPU
    (an entry point never falls back to the CPU by itself)."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: txt2vid_tpu_torch runs on the GPU; "
                           "pass device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")
