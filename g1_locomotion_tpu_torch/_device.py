"""Device helpers. The port has no global default device: every function
that creates a tensor takes its device, and GPU entry points ask for the
card here."""

from __future__ import annotations

import contextlib
import functools

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "g1_locomotion_tpu_torch: this entry point needs a CUDA device and "
            "torch.cuda.is_available() is False"
        )
    return torch.device("cuda", torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _cached(values, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant tensor (`values`: a number or nested tuples) on `like`'s
    device and dtype, made once per device and dtype: a call inside a
    control period copies nothing from the host."""
    return _cached(values, like.device, like.dtype)


@contextlib.contextmanager
def capturable_lu(like: torch.Tensor):
    """Batched LU factorizations and solves of the enclosed calls through
    cuSOLVER and cuBLAS on `like`'s card: PyTorch's default picks MAGMA's
    batched LU for a batch of more than one, which waits on the host, and a
    CUDA graph's capture refuses that. PyTorch takes the library from a
    process-wide preference, set here and restored after; on the CPU
    nothing changes."""
    if like.device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
