"""g1_locomotion_tpu_torch — the PyTorch / CUDA port of g1_locomotion_tpu.

The JAX package ``g1_locomotion_tpu`` is the reference; this package mirrors
its module paths and public names (``models/srbd.py``, ``ops/qp.py``,
``mpc/solver.py``, ...) so each module's counterpart is easy to find. It
imports ``torch`` and never ``jax``.

The four Pallas TPU kernels of the reference (``ops/pallas_lin.py``) are
hand-written CUDA C++ kernels for Hopper (``csrc/lin_kernels.cu``), bound
through ``ops/cuda_lin.py``.
"""

import torch as _torch

# Control-grade numerics, as in the reference package: the QPs are
# ill-conditioned (cond(H) up to ~1e10) and solved in float32 on the card.
# Reduced-precision matmuls (TF32 keeps ~3 decimal digits) shift contact
# forces by more than 10%, so every float32 product runs in IEEE fp32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
