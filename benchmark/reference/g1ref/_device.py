"""Device helpers. The port has no global default device: every function
that creates a tensor takes its device, and GPU entry points ask for the
card here."""

from __future__ import annotations

import functools

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "benchmark.reference.g1ref: this entry point needs a CUDA device and "
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
