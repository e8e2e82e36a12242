"""The QP's four dense linear-algebra kernels: CUDA wrappers and plain versions.

Counterpart of ``g1_locomotion_tpu/ops/pallas_lin.py``. Each Pallas TPU
kernel there is a hand-written CUDA C++ kernel for Hopper (sm_90a) in
``csrc/lin_kernels.cu``:

========================  ==========================================  ==========================
wrapper                   replaces (g1_locomotion_tpu/ops/...)        plain version
========================  ==========================================  ==========================
``chol_inverse_base``     ``pallas_lin.py:chol_inverse_base`` (B1)    ``chol_inverse_base_ref``
``gj_inverse``            ``pallas_lin.py:gj_inverse`` (B2)           ``gj_inverse_ref``
``gj_solve``              ``pallas_lin.py:gj_solve`` (B3)             ``gj_solve_ref``
``admm_iterate``          ``pallas_lin.py:admm_iterate`` (B4)         ``admm_iterate_ref``
========================  ==========================================  ==========================

Every wrapper takes a batch ``(B, ...)`` and dispatches on the device of
its input alone: a CPU tensor goes to the plain PyTorch version, a CUDA
tensor launches the kernel (or raises). There is no fallback from one to
the other. ``<wrapper>.launches`` counts the kernel's launches.

The CUDA source is compiled at first use with ``nvcc`` into a shared
library with a plain C interface under ``g1_locomotion_tpu_torch/_build/``
and loaded with ``ctypes``; a CPU call never reaches the loader.

B1 reads and writes strided blocks: ``K`` and ``out`` may be views of larger
matrices (any batch and row stride, unit column stride), so the recursion of
``ops/lin.py`` hands it blocks where they lie.

Routes: ``gj_plan`` and ``admm_plan`` name the kernel a call launches, and
shared memory per block (``MAX_SMEM_BYTES`` is what a Hopper block can use),
in elements of the working type; B1 takes 64 per matrix.

* B2 and B3 at float32 within the register tile (``GJ_TILE``: B2 m <= 128,
  B3 m <= 208): ``"tile"``, two small static buffers;
* B3 at float32 past it, m <= ``GJ_CLUSTER_MAX_M`` (240; the roll-moment
  cap's m = 210): ``"cluster"``, the tile split over a two-CTA thread-block
  cluster (``GJ_CLUSTER``), small static buffers in each CTA;
* else (float64, B2 past its tile): ``"smem"``, the in-place array and the
  saved column, ``m w + m`` with ``w = m`` for B2 and ``m + 1`` for B3
  (m <= 240 at float32, m <= 169 at float64);
* B4 at float32 with n <= 128: ``"tile13"`` for m <= 208 (``ADMM_TILE``) and
  ``"tile14"`` for m <= 224 (``ADMM_TILE_WIDE``), a few static vectors;
  else ``"smem"``, ``n^2 + m n + 4 n + 7 m``.

A system that no route takes raises ValueError; a launch the card refuses
raises RuntimeError. Nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lin_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
MAX_SMEM_BYTES = 232448  # dynamic shared memory a block may use on Hopper
BASE_MAX = 32            # largest block the Cholesky base kernel takes
BASE_WARPS = 4           # matrices (warps) per block of the Cholesky base kernel
# (rows, columns) of the float32 register tiles of B2 and B3, as in the CUDA
# source: kGj<Kind>W * kGj<Kind>R and 32 * kGj<Kind>C.
GJ_TILE = {"gj_inverse": (128, 128), "gj_solve": (208, 224)}
# (rows, columns) of B3's float32 cluster tile: kGjClusterCtas * kGjClusterW *
# kGjClusterR and 32 * kGjClusterC. The plan sends it the systems past
# GJ_TILE up to GJ_CLUSTER_MAX_M, the float32 widths the shared-memory kernel
# took before it (its array fills a block's shared memory at m = 240).
GJ_CLUSTER = (256, 256)
GJ_CLUSTER_MAX_M = 240
# (rows of A, columns) of B4's float32 register tiles: kAdmmW * kAdmmRA (or
# kAdmmRAWide) and 32 * kAdmmC (K^-1's rows, kAdmmW * kAdmmRK, cover the
# columns).
ADMM_TILE = (208, 128)
ADMM_TILE_WIDE = (224, 128)
# Each plan's routes and the code its C entry point takes for them
# (csrc/lin_kernels.cu: launch_gj's GjRoute, launch_admm's rows of A a thread).
GJ_ROUTES = {"smem": 0, "tile": 1, "cluster": 2}
ADMM_ROUTES = {"smem": 0, "tile13": 13, "tile14": 14}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    "lin_chol_inv_base": [_P, _P, _I, _I, _L, _L, _L, _L, _I, _P],
    "lin_gj_inverse": [_P, _P, _I, _I, _I, _P],
    "lin_gj_solve": [_P, _P, _P, _I, _I, _I, _P],
    "lin_admm_iterate": [_P] * 12 + [_I, _I, _I, _I, _D, _D, _I, _P],
}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path(source: Path = SOURCE) -> Path:
    """Where the library built from `source` lives; the name carries a hash
    of the source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}.so"


def build(verbose: bool = False, source: Path = SOURCE) -> Tuple[Path, float, str]:
    """Compile `source` (``csrc/lin_kernels.cu``) if its library is missing.

    Returns (library path, seconds spent compiling (0 if it was built),
    the compiler's output). With ``verbose`` the compiler reports each
    kernel's registers and shared memory (``-Xptxas -v``).
    """
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, seconds, proc.stdout + proc.stderr


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, dtype: torch.dtype, *args) -> None:
    suffix = "f32" if dtype == torch.float32 else "f64"
    err = getattr(_lib(), f"{name}_{suffix}")(*args)
    if err != 0:
        raise RuntimeError(f"{name}_{suffix}: CUDA error {err} at launch")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name: str, tensors: Dict[str, torch.Tensor], shapes: Dict[str, tuple],
           strided: bool = False) -> None:
    """Raise unless every tensor is a contiguous CUDA float32/float64 tensor of
    one dtype and one device, with the expected shape. With ``strided`` a
    (B, n, n) tensor may instead have any non-negative batch and row strides,
    with unit column stride."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}; the kernel takes CUDA tensors "
                             f"(the plain version runs when every input is on the CPU)")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != first.dtype:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}; all must be one of float32/float64")
        if t.device != first.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {first.device}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")
        if strided:
            if t.stride(-1) != 1 or min(t.stride()) < 0:
                raise ValueError(f"{name}: {key} has strides {t.stride()}; the kernel takes "
                                 f"unit column stride and non-negative batch and row strides")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_smem(name: str, dtype: torch.dtype, elements: int) -> int:
    """Bytes of dynamic shared memory for `elements` values; raises above the
    block's limit."""
    nbytes = elements * (4 if dtype == torch.float32 else 8)
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: needs {nbytes} B of shared memory per block, above the "
            f"{MAX_SMEM_BYTES} B a Hopper block can use"
        )
    return nbytes


def launch_counts() -> Dict[str, int]:
    """{wrapper name: launches of its kernel}."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def route_counts() -> Dict[str, Dict[str, int]]:
    """{wrapper name: {route: launches}}: which kernel each launch took (B1
    has the one route ``"warp"``)."""
    return {fn.__name__: dict(fn.routes) for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.routes = {}


def _count(name: str, route: str) -> None:
    """One launch of kernel `name` by `route`, on the wrapper's own counters
    (found by name, so a caller that swaps the module attribute still
    counts)."""
    fn = _BY_NAME[name]
    fn.launches += 1
    fn.routes[route] = fn.routes.get(route, 0) + 1


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., r, c) x (..., c) -> (..., r)."""
    return (M @ v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# B1: Cholesky-inverse base case
# ---------------------------------------------------------------------------


def chol_inverse_base_ref(K: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B1: W = L^-1 with K = L L' for (..., n, n), n small,
    returned, or copied into ``out`` (which may be a view) where that is given.

    Column Cholesky (diagonal clamped at 1e-30, one reciprocal per column) and
    forward substitution on the identity, in the kernel's order of steps:
    step j takes column j of L from the trailing matrix, subtracts its outer
    product from the columns right of it, finishes row j of W and adds its
    share to the rows below. (The kernel never forms L: it carries the 1 / d
    of L[:, j] in the other factor of each product, the same to rounding.)
    Only the lower triangle of K is read.
    """
    n = K.shape[-1]
    a = torch.tril(K)  # trailing matrix, lower triangle
    acc = torch.zeros_like(K)  # acc[r, c] = sum_k L[r, k] W[k, c] over the columns done
    W = torch.zeros_like(K)
    for j in range(n):
        d = torch.sqrt(torch.clamp(a[..., j, j], min=1e-30))
        rd = 1 / d
        col = a[..., j + 1 :, j] * rd[..., None]  # L[j+1:, j]
        a[..., j + 1 :, j + 1 :] -= torch.tril(col[..., :, None] * col[..., None, :])
        w = -acc[..., j, : j + 1]
        w[..., j] += 1
        w = w * rd[..., None]
        W[..., j, : j + 1] = w
        acc[..., j + 1 :, : j + 1] += col[..., :, None] * w[..., None, :]
    return W if out is None else out.copy_(W)


def chol_inverse_base(K: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1: W = L^-1 with K = L L' for SPD K (B, n, n), n <= 32.

    ``K`` and ``out`` may be strided views (a block of a larger matrix): any
    batch and row stride, unit column stride. With ``out`` the result is
    written there, zeros above the diagonal included, and ``out`` is returned.
    """
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"chol_inverse_base: K must be (B, n, n), got {tuple(K.shape)}")
    if out is not None and (out.shape != K.shape or out.dtype != K.dtype
                            or out.device != K.device):
        raise ValueError(f"chol_inverse_base: out is {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, K {tuple(K.shape)} {K.dtype} on {K.device}")
    if K.device.type == "cpu":
        return chol_inverse_base_ref(K, out)
    B, n, _ = K.shape
    if out is None:
        out = torch.empty_like(K, memory_format=torch.contiguous_format)
    _check("chol_inverse_base", {"K": K, "out": out}, {"K": (B, n, n), "out": (B, n, n)},
           strided=True)
    if not 1 <= n <= BASE_MAX:
        raise ValueError(f"chol_inverse_base: n = {n}, the kernel takes 1 <= n <= {BASE_MAX}")
    block = (n - 1) * out.stride(1) + n  # elements from a block's first to its last
    if (n > 1 and out.stride(1) < n) or (B > 1 and out.stride(0) < block):
        raise ValueError(f"chol_inverse_base: out has strides {out.stride()}: its rows or "
                         f"blocks overlap")
    _launch("lin_chol_inv_base", K.dtype, _ptr(K), _ptr(out), B, n, K.stride(0), K.stride(1),
            out.stride(0), out.stride(1), BASE_WARPS, _stream(K))
    _count("chol_inverse_base", "warp")
    return out


# ---------------------------------------------------------------------------
# B2 / B3: unpivoted Gauss-Jordan inverse and solve
# ---------------------------------------------------------------------------


def gj_plan(name: str, m: int, dtype: torch.dtype) -> Tuple[str, int]:
    """Which kernel B2 (``gj_inverse``) or B3 (``gj_solve``) launches for an
    m-wide system, as (route, bytes of dynamic shared memory):

    * ``("tile", 0)``: the float32 register tile, where the system, with b
      as one more column for B3, fits ``GJ_TILE`` (zero padding to the tile
      happens in the kernel's registers);
    * ``("cluster", 0)``: B3 at float32 past the tile, m <=
      ``GJ_CLUSTER_MAX_M``: the register tile split over a two-CTA cluster;
    * ``("smem", bytes)``: the shared-memory kernel, which holds the in-place
      (m, w) array and the saved column (m). Raises ValueError where that
      exceeds ``MAX_SMEM_BYTES``."""
    if m < 1:
        raise ValueError(f"{name}: m = {m} < 1")
    w = m + 1 if name == "gj_solve" else m
    rows, cols = GJ_TILE[name]
    if dtype == torch.float32:
        if m <= rows and w <= cols:
            return "tile", 0
        if name == "gj_solve" and m <= GJ_CLUSTER_MAX_M:
            return "cluster", 0
    return "smem", _check_smem(name, dtype, m * w + m)


def _gj_eliminate(a: torch.Tensor, solve: bool) -> torch.Tensor:
    """Unpivoted in-place Gauss-Jordan on a copy of the (..., m, w) array, in
    the kernels' order of operations. Step j saves column j as the factors
    (entry j zeroed), for the inverse sets column j to e_j, multiplies row j by
    1 / pivot, and subtracts factor * row j from every row. The solve
    (w = m + 1) touches only columns > j; the inverse (w = m) all of them, and
    ends with K^-1 in place of K."""
    a = a.clone()
    m = a.shape[-2]
    for j in range(m):
        piv = a[..., j, j].clone()
        col = a[..., :, j].clone()
        col[..., j] = 0
        if not solve:
            a[..., :, j] = 0
            a[..., j, j] = 1
        c0 = j + 1 if solve else 0
        prow = a[..., j, c0:] * (1 / piv)[..., None]
        a[..., j, c0:] = prow
        a[..., :, c0:] -= col[..., :, None] * prow[..., None, :]
    return a


def gj_inverse_ref(K: torch.Tensor) -> torch.Tensor:
    """Plain version of B2: K^-1 for SPD + ridge K (..., m, m) by unpivoted
    in-place Gauss-Jordan elimination (the reference eliminates [K | I] in the
    same order of pivots)."""
    return _gj_eliminate(K, solve=False)


def gj_solve_ref(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: x = K^-1 b for SPD + ridge K (..., m, m), b (..., m),
    by unpivoted Gauss-Jordan elimination on [K | b]."""
    return _gj_eliminate(torch.cat([K, b[..., None]], dim=-1), solve=True)[..., -1]


def gj_inverse(K: torch.Tensor) -> torch.Tensor:
    """B2: K^-1 for SPD + ridge K (B, m, m)."""
    if K.device.type == "cpu":
        return gj_inverse_ref(K)
    if K.dim() != 3:
        raise ValueError(f"gj_inverse: K must be (B, m, m), got {tuple(K.shape)}")
    B, m, _ = K.shape
    _check("gj_inverse", {"K": K}, {"K": (B, m, m)})
    route, _ = gj_plan("gj_inverse", m, K.dtype)
    out = torch.empty_like(K)
    _launch("lin_gj_inverse", K.dtype, _ptr(K), _ptr(out), B, m, GJ_ROUTES[route], _stream(K))
    _count("gj_inverse", route)
    return out


def gj_solve(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B3: x = K^-1 b for SPD + ridge K (B, m, m) and b (B, m)."""
    if K.device.type == "cpu" and b.device.type == "cpu":
        return gj_solve_ref(K, b)
    if K.dim() != 3:
        raise ValueError(f"gj_solve: K must be (B, m, m), got {tuple(K.shape)}")
    B, m, _ = K.shape
    _check("gj_solve", {"K": K, "b": b}, {"K": (B, m, m), "b": (B, m)})
    route, _ = gj_plan("gj_solve", m, K.dtype)
    x = torch.empty_like(b)
    _launch("lin_gj_solve", K.dtype, _ptr(K), _ptr(b), _ptr(x), B, m, GJ_ROUTES[route],
            _stream(K))
    _count("gj_solve", route)
    return x


# ---------------------------------------------------------------------------
# B4: a segment of relaxed ADMM iterations with a fixed K^-1
# ---------------------------------------------------------------------------


def admm_iterate_ref(Kinv, A, q, l, u, rho_vec, x, z, y, num: int, sigma: float,
                     alpha: float):
    """Plain version of B4: ``num`` relaxed-ADMM iterations of the batched QP
    (Kinv (..., n, n), A (..., m, n), vectors (..., n) / (..., m)), the update
    of ops/qp.py's iteration loop with x~ = K^-1 rhs. Returns (x, z, y)."""
    for _ in range(num):
        rhs = sigma * x - q + _mv(A.mT, rho_vec * z - y)
        x_t = _mv(Kinv, rhs)
        z_t = _mv(A, x_t)
        x_n = alpha * x_t + (1 - alpha) * x
        z_ax = alpha * z_t + (1 - alpha) * z
        z_n = torch.clamp(z_ax + y / rho_vec, min=l, max=u)
        y = y + rho_vec * (z_ax - z_n)
        x, z = x_n, z_n
    return x, z, y


def admm_plan(n: int, m: int, dtype: torch.dtype) -> Tuple[str, int]:
    """Which kernel B4 launches for n variables and m rows, as (route, bytes
    of dynamic shared memory): ``("tile13", 0)`` or ``("tile14", 0)`` for the
    float32 register tile with 13 or 14 rows of A a thread, where the QP fits
    ``ADMM_TILE`` or ``ADMM_TILE_WIDE`` (zero padding to the tile happens in
    the kernel's registers); else ``("smem", bytes)`` for the shared-memory
    kernel, which holds K^-1, A and eleven vectors. Raises ValueError where
    that exceeds ``MAX_SMEM_BYTES``."""
    if n < 1 or m < 1:
        raise ValueError(f"admm_iterate: n = {n}, m = {m}; both must be >= 1")
    if dtype == torch.float32:
        for route, (rows, cols) in (("tile13", ADMM_TILE), ("tile14", ADMM_TILE_WIDE)):
            if m <= rows and n <= cols:
                return route, 0
    return "smem", _check_smem("admm_iterate", dtype, n * n + m * n + 4 * n + 7 * m)


def admm_iterate(Kinv, A, q, l, u, rho_vec, x, z, y, num: int, sigma: float, alpha: float):
    """B4: ``num`` relaxed-ADMM iterations per instance, K^-1 fixed; (x, z, y)."""
    args = {"Kinv": Kinv, "A": A, "q": q, "l": l, "u": u, "rho_vec": rho_vec,
            "x": x, "z": z, "y": y}
    if all(t.device.type == "cpu" for t in args.values()):
        return admm_iterate_ref(Kinv, A, q, l, u, rho_vec, x, z, y, num, sigma, alpha)
    if A.dim() != 3:
        raise ValueError(f"admm_iterate: A must be (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    vec_n, vec_m = (B, n), (B, m)
    _check("admm_iterate", args, {
        "Kinv": (B, n, n), "A": (B, m, n), "q": vec_n, "l": vec_m, "u": vec_m,
        "rho_vec": vec_m, "x": vec_n, "z": vec_m, "y": vec_m,
    })
    if num < 0:
        raise ValueError(f"admm_iterate: num = {num} < 0")
    route, _ = admm_plan(n, m, A.dtype)
    xo, zo, yo = torch.empty_like(x), torch.empty_like(z), torch.empty_like(y)
    _launch(
        "lin_admm_iterate", A.dtype,
        *(_ptr(t) for t in (Kinv, A, q, l, u, rho_vec, x, z, y, xo, zo, yo)),
        B, n, m, int(num), float(sigma), float(alpha), ADMM_ROUTES[route], _stream(A),
    )
    _count("admm_iterate", route)
    return xo, zo, yo


KERNELS = (chol_inverse_base, gj_inverse, gj_solve, admm_iterate)
PLAIN = {
    "chol_inverse_base": chol_inverse_base_ref,
    "gj_inverse": gj_inverse_ref,
    "gj_solve": gj_solve_ref,
    "admm_iterate": admm_iterate_ref,
}
_BY_NAME = {fn.__name__: fn for fn in KERNELS}
reset_launch_counts()
