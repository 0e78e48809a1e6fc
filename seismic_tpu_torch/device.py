"""Device selection shared by the package's entry points."""

from __future__ import annotations

import contextlib


def resolve_device(device=None):
    """`None` means the card: returns `torch.device("cuda")`, and raises
    when CUDA is absent. The CPU is used only when the caller asks for it
    (the tests pass `device="cpu"`); nothing falls back silently."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32():
    """f32 matrix products in full f32 (TF32 off) inside the block; the
    setting before it is restored after it."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
