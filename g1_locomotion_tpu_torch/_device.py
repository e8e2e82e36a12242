"""Device helpers. The port has no global default device: every function
that creates a tensor takes its device, and GPU entry points ask for the
card here."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The CUDA device, or a RuntimeError when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "g1_locomotion_tpu_torch: this entry point needs a CUDA device and "
            "torch.cuda.is_available() is False"
        )
    return torch.device("cuda", torch.cuda.current_device())
