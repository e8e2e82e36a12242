"""ctypes binding of the native dense IPM QP solver (``native/qp_solver.cpp``).

The port's own binding of the same C++ source as
``g1_locomotion_tpu/ops/native_qp.py``: a host-side float64 interior-point
solver for single problems, the high-accuracy oracle that the batched ADMM
of :mod:`.qp` is held against. Nothing on the card's path calls it.

Built at first use with ``g++`` into ``g1_locomotion_tpu_torch/_build/``,
the library's name carrying a hash of the source and the flags (as the
kernels' ``liblin_kernels_<hash>.so``), so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "qp_solver.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libqp_solver_{digest[:16]}.so"


def build() -> Path:
    """Compile the shared library if it is missing. Returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native QP solver is built with g++, which is not on PATH") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native QP solver build failed (exit {proc.returncode}):\n"
                           f"  {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    arr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.qp_solve_dense.restype = ctypes.c_int
    lib.qp_solve_dense.argtypes = [
        ctypes.c_int, ctypes.c_int, arr, arr, arr, arr, arr,
        ctypes.c_int, ctypes.c_double, arr, arr, arr,
    ]
    return lib


class NativeQPResult(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    status: int  # 0 ok, 1 max-iter, 2 numerical failure
    iters: int
    gap: float


def solve(H, g, A, l, u, max_iter: int = 50, tol: float = 1e-10) -> NativeQPResult:
    """Solve min 0.5 x'Hx + g'x s.t. l <= Ax <= u at float64 on the host (one
    problem: H (n, n), g (n,), A (m, n), l and u (m,); numpy arrays or CPU
    tensors)."""
    H, g, A, l, u = (np.ascontiguousarray(np.asarray(a), np.float64) for a in (H, g, A, l, u))
    n, m = H.shape[0], A.shape[0]
    if H.shape != (n, n) or g.shape != (n,) or A.shape != (m, n) or l.shape != (m,) \
            or u.shape != (m,):
        raise ValueError(f"native QP: shapes H {H.shape}, g {g.shape}, A {A.shape}, "
                         f"l {l.shape}, u {u.shape} do not form one problem")
    x, y, info = np.zeros(n), np.zeros(m), np.zeros(2)
    status = _lib().qp_solve_dense(n, m, H, g, A, l, u, max_iter, tol, x, y, info)
    return NativeQPResult(x=x, y=y, status=int(status), iters=int(info[0]), gap=float(info[1]))
