// Hand-written Hopper (sm_90a) kernels for the QP's dense linear algebra.
//
// Each kernel replaces one Pallas TPU kernel of the reference package
// (g1_locomotion_tpu/ops/pallas_lin.py) and computes what that kernel
// computes. None is carried over block by block: the TPU kernels put the
// batch on the 128-lane axis and pad to (8, 128) tiles, which has no meaning
// here. On the card every kernel runs one instance (or a few) per thread
// block, with a grid over the batch, so B = 1 serving and B = 4096
// throughput launch the same code.
//
// Build (plain C interface, loaded with ctypes by ops/cuda_lin.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o liblin_kernels.so lin_kernels.cu
//
// Every entry point launches on the stream it is given, does not
// synchronize, allocates nothing, and returns cudaGetLastError() so that a
// refused launch (too much shared memory, bad configuration) is reported to
// the caller, which raises.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// Largest dynamic shared memory a block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// B1: Cholesky-inverse base case.
//
// Replaces g1_locomotion_tpu/ops/pallas_lin.py:chol_inverse_base
// (_chol_inv_kernel): W = L^-1 with K = L L^T for a batch of SPD blocks
// (B, n, n), n <= 32, the base case of the recursive matmul-only SPD inverse
// (ops/lin.py). Column Cholesky with the diagonal clamped at 1e-30, then
// forward substitution on the identity.
//
// What bounds it: the factorization is a chain of n dependent column steps
// on ~n^3/3 flops; a 30x30 block is 3.6 KB, so the work is latency of the
// sequential steps, not bytes or flops. Design: one warp per matrix, one
// lane per row (Cholesky) or per column (substitution); L and W live in
// shared memory with a padded row stride (33, coprime with the 32 banks) so
// a lane walking its own row hits a distinct bank; steps are separated by
// __syncwarp() only, and the pivot reaches all lanes by a warp shuffle.
// Several warps (matrices) share a block to keep the SM occupied.
// ---------------------------------------------------------------------------

constexpr int kBaseLd = 33;
constexpr int kBaseMatsPerBlock = 4;

template <typename T>
__global__ void chol_inv_base_kernel(const T* __restrict__ K, T* __restrict__ W,
                                     int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x;
  const int slot = threadIdx.y;
  const int b = blockIdx.x * kBaseMatsPerBlock + slot;
  if (b >= batch) return;  // a whole warp leaves together
  T* L = smem + slot * 2 * kWarp * kBaseLd;
  T* Wt = L + kWarp * kBaseLd;
  const T* Kb = K + static_cast<size_t>(b) * n * n;

  for (int idx = lane; idx < n * n; idx += kWarp) {
    L[(idx / n) * kBaseLd + idx % n] = Kb[idx];
  }
  __syncwarp();

  // Left-looking Cholesky in place over the lower triangle of K.
  const int i = lane;
  for (int j = 0; j < n; ++j) {
    T s = T(0);
    if (i >= j && i < n) {
      T acc = T(0);
      for (int k = 0; k < j; ++k) acc += L[i * kBaseLd + k] * L[j * kBaseLd + k];
      s = L[i * kBaseLd + j] - acc;
    }
    T d = __shfl_sync(kFullMask, s, j);
    d = sqrt(d < T(1e-30) ? T(1e-30) : d);  // NaN stays NaN
    if (i == j) {
      L[i * kBaseLd + j] = d;
    } else if (i > j && i < n) {
      L[i * kBaseLd + j] = s / d;
    }
    __syncwarp();
  }

  // Forward substitution on the identity, one row of W per step:
  // W[r, c] = (delta_rc - sum_{k<r} L[r, k] W[k, c]) / L[r, r], lane = c.
  const int c = lane;
  for (int r = 0; r < n; ++r) {
    if (c < n) {
      T acc = T(0);
      for (int k = 0; k < r; ++k) acc += L[r * kBaseLd + k] * Wt[k * kBaseLd + c];
      Wt[r * kBaseLd + c] = ((r == c ? T(1) : T(0)) - acc) / L[r * kBaseLd + r];
    }
    __syncwarp();
  }

  T* Wb = W + static_cast<size_t>(b) * n * n;
  for (int idx = lane; idx < n * n; idx += kWarp) {
    Wb[idx] = Wt[(idx / n) * kBaseLd + idx % n];
  }
}

template <typename T>
cudaError_t launch_chol_inv_base(const T* K, T* W, int batch, int n, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || n > kWarp) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * kBaseMatsPerBlock * 2 * kWarp * kBaseLd;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&chol_inv_base_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const dim3 block(kWarp, kBaseMatsPerBlock);
  const dim3 grid((batch + kBaseMatsPerBlock - 1) / kBaseMatsPerBlock);
  chol_inv_base_kernel<T><<<grid, block, smem, stream>>>(K, W, batch, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2 / B3: unpivoted Gauss-Jordan elimination on an augmented system.
//
// Replace g1_locomotion_tpu/ops/pallas_lin.py:gj_inverse (its inner
// `kernel`) and :gj_solve (_gj_solve_kernel): K^-1 by elimination on
// [K | I], and x = K^-1 b by elimination on [K | b]. Step j scales row j by
// nothing and subtracts f_i * row_j from every other row, f_i = a_ij / a_jj;
// after m steps the left block is diagonal and each result row is divided
// by its diagonal entry. No pivoting: the systems are SPD + ridge (the QP's
// KKT matrix and the polish Hr and Schur complement), where unpivoted
// elimination is stable. Do not use it on general matrices.
//
// What bounds it: m dependent elimination steps, each a rank-1 update of the
// whole augmented matrix (m x 2m for B2 at m = 120, m x (m+1) for B3 at
// m = 200): ~2m^3 flops of shared-memory read-modify-write and two block
// barriers per step; the data (115 KB / 161 KB at f32) is read from device
// memory once. Design: one block per instance, the augmented matrix
// resident in dynamic shared memory (above 48 KB, raised with
// cudaFuncSetAttribute), one warp per row so each row update is a
// conflict-free sweep along the row.
// ---------------------------------------------------------------------------

constexpr int kGjRowsPerPass = 16;  // warps per block

template <typename T>
__device__ void gj_eliminate(T* aug, T* f, int m, int w) {
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  const int nthreads = kWarp * kGjRowsPerPass;
  for (int j = 0; j < m; ++j) {
    const T piv = aug[j * w + j];
    for (int r = tid; r < m; r += nthreads) f[r] = (r == j) ? T(0) : aug[r * w + j] / piv;
    __syncthreads();
    const T* prow = aug + j * w;
    for (int r = threadIdx.y; r < m; r += kGjRowsPerPass) {
      if (r == j) continue;
      const T fr = f[r];
      T* row = aug + r * w;
      for (int c = threadIdx.x; c < w; c += kWarp) row[c] -= fr * prow[c];
    }
    __syncthreads();
  }
}

template <typename T, bool kSolve>
__global__ void gj_kernel(const T* __restrict__ K, const T* __restrict__ rhs, T* __restrict__ out,
                          int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* aug = reinterpret_cast<T*>(smem_raw);
  const int w = kSolve ? m + 1 : 2 * m;
  T* f = aug + m * w;
  const size_t b = blockIdx.x;
  const T* Kb = K + b * m * m;

  for (int r = threadIdx.y; r < m; r += kGjRowsPerPass) {
    for (int c = threadIdx.x; c < w; c += kWarp) {
      T v;
      if (c < m) {
        v = Kb[r * m + c];
      } else if (kSolve) {
        v = rhs[b * m + r];
      } else {
        v = (c - m == r) ? T(1) : T(0);
      }
      aug[r * w + c] = v;
    }
  }
  __syncthreads();

  gj_eliminate(aug, f, m, w);

  if (kSolve) {
    const int tid = threadIdx.y * kWarp + threadIdx.x;
    for (int r = tid; r < m; r += kWarp * kGjRowsPerPass) {
      out[b * m + r] = aug[r * w + m] / aug[r * w + r];
    }
  } else {
    for (int r = threadIdx.y; r < m; r += kGjRowsPerPass) {
      const T diag = aug[r * w + r];
      for (int c = threadIdx.x; c < m; c += kWarp) {
        out[b * m * m + r * m + c] = aug[r * w + m + c] / diag;
      }
    }
  }
}

template <typename T, bool kSolve>
cudaError_t launch_gj(const T* K, const T* rhs, T* out, int batch, int m, cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (m < 1) return cudaErrorInvalidValue;
  const size_t w = kSolve ? m + 1 : 2 * static_cast<size_t>(m);
  const size_t smem = sizeof(T) * (m * w + m);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&gj_kernel<T, kSolve>), smem);
  if (err != cudaSuccess) return err;
  gj_kernel<T, kSolve><<<batch, dim3(kWarp, kGjRowsPerPass), smem, stream>>>(K, rhs, out, m);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B4: a segment of relaxed ADMM iterations with K^-1 fixed.
//
// Replaces g1_locomotion_tpu/ops/pallas_lin.py:admm_iterate (_admm_kernel):
// `num` iterations of
//   rhs = sigma x - q + A^T (rho z - y);  x~ = K^-1 rhs;  z~ = A x~
//   x = alpha x~ + (1 - alpha) x;  z_a = alpha z~ + (1 - alpha) z
//   z = clip(z_a + y / rho, l, u);  y = y + rho (z_a - z)
// x~ is applied as K^-1 rhs, as the reference's XLA loop does (ops/qp.py);
// the TPU kernel's rhs K^-T sums the same products.
//
// What bounds it: three matrix-vector products per iteration over K^-1
// (n x n) and A (m x n), ~2(n^2 + 2mn) flops against 4(n^2 + mn) bytes: at
// n = 120, m = 200 that is 0.5 flop per byte, memory-bound if the operands
// were re-read from device memory every iteration. Design: one block per
// instance; K^-1 (57.6 KB) and A (96 KB) are read from device memory once
// into shared memory (153.6 KB at f32) and stay there for all `num`
// iterations, with every vector. A^T is never stored: A^T w runs one thread
// per column down A's rows (consecutive threads, consecutive addresses);
// K^-1 rhs and A x~ run one warp per row with a shuffle reduction.
// ---------------------------------------------------------------------------

constexpr int kAdmmWarps = 8;

template <typename T>
__device__ void warp_matvec(const T* M, const T* v, T* out, int rows, int cols) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int r = warp; r < rows; r += kAdmmWarps) {
    T acc = T(0);
    for (int c = lane; c < cols; c += kWarp) acc += M[r * cols + c] * v[c];
    for (int off = kWarp / 2; off > 0; off /= 2) acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) out[r] = acc;
  }
}

template <typename T>
__global__ void admm_kernel(const T* __restrict__ Kinv, const T* __restrict__ A,
                            const T* __restrict__ q, const T* __restrict__ l,
                            const T* __restrict__ u, const T* __restrict__ rho,
                            const T* __restrict__ x0, const T* __restrict__ z0,
                            const T* __restrict__ y0, T* __restrict__ xo, T* __restrict__ zo,
                            T* __restrict__ yo, int n, int m, int num, T sigma, T alpha,
                            T beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // (n, n)
  T* sA = sK + n * n;                      // (m, n)
  T* x = sA + m * n;
  T* xt = x + n;
  T* rhs = xt + n;
  T* qv = rhs + n;
  T* z = qv + n;
  T* y = z + m;
  T* zt = y + m;
  T* wv = zt + m;
  T* lv = wv + m;
  T* uv = lv + m;
  T* rv = uv + m;

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < n * n; i += nthreads) sK[i] = Kinv[b * n * n + i];
  for (int i = tid; i < m * n; i += nthreads) sA[i] = A[b * m * n + i];
  for (int i = tid; i < n; i += nthreads) {
    x[i] = x0[b * n + i];
    qv[i] = q[b * n + i];
  }
  for (int i = tid; i < m; i += nthreads) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    lv[i] = l[b * m + i];
    uv[i] = u[b * m + i];
    rv[i] = rho[b * m + i];
  }
  __syncthreads();

  for (int it = 0; it < num; ++it) {
    for (int i = tid; i < m; i += nthreads) wv[i] = rv[i] * z[i] - y[i];
    __syncthreads();
    for (int j = tid; j < n; j += nthreads) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc += sA[i * n + j] * wv[i];
      rhs[j] = sigma * x[j] - qv[j] + acc;
    }
    __syncthreads();
    warp_matvec(sK, rhs, xt, n, n);
    __syncthreads();
    warp_matvec(sA, xt, zt, m, n);
    __syncthreads();
    for (int j = tid; j < n; j += nthreads) x[j] = alpha * xt[j] + beta * x[j];
    for (int i = tid; i < m; i += nthreads) {
      const T za = alpha * zt[i] + beta * z[i];
      T zn = za + y[i] / rv[i];
      zn = zn > lv[i] ? zn : lv[i];
      zn = zn < uv[i] ? zn : uv[i];
      y[i] = y[i] + rv[i] * (za - zn);
      z[i] = zn;
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nthreads) xo[b * n + i] = x[i];
  for (int i = tid; i < m; i += nthreads) {
    zo[b * m + i] = z[i];
    yo[b * m + i] = y[i];
  }
}

template <typename T>
cudaError_t launch_admm(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
                        const T* rho, const T* x, const T* z, const T* y, T* xo, T* zo, T* yo,
                        int batch, int n, int m, int num, double sigma, double alpha,
                        cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || m < 1 || num < 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (static_cast<size_t>(n) * n + static_cast<size_t>(m) * n +
                                   4 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m));
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(&admm_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  admm_kernel<T><<<batch, kAdmmWarps * kWarp, smem, stream>>>(
      Kinv, A, q, l, u, rho, x, z, y, xo, zo, yo, n, m, num, static_cast<T>(sigma),
      static_cast<T>(alpha), static_cast<T>(1.0 - alpha));
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers of contiguous
// row-major tensors; `stream` is a cudaStream_t. Returns a cudaError_t.
// ---------------------------------------------------------------------------

#define LIN_DEFINE_ENTRIES(T, SUFFIX)                                                           \
  extern "C" int lin_chol_inv_base_##SUFFIX(const T* K, T* W, int batch, int n, void* stream) { \
    return launch_chol_inv_base<T>(K, W, batch, n, static_cast<cudaStream_t>(stream));        \
  }                                                                                             \
  extern "C" int lin_gj_inverse_##SUFFIX(const T* K, T* out, int batch, int m, void* stream) { \
    return launch_gj<T, false>(K, nullptr, out, batch, m, static_cast<cudaStream_t>(stream));  \
  }                                                                                             \
  extern "C" int lin_gj_solve_##SUFFIX(const T* K, const T* b, T* x, int batch, int m,         \
                                       void* stream) {                                          \
    return launch_gj<T, true>(K, b, x, batch, m, static_cast<cudaStream_t>(stream));           \
  }                                                                                             \
  extern "C" int lin_admm_iterate_##SUFFIX(                                                     \
      const T* Kinv, const T* A, const T* q, const T* l, const T* u, const T* rho, const T* x, \
      const T* z, const T* y, T* xo, T* zo, T* yo, int batch, int n, int m, int num,            \
      double sigma, double alpha, void* stream) {                                               \
    return launch_admm<T>(Kinv, A, q, l, u, rho, x, z, y, xo, zo, yo, batch, n, m, num, sigma,  \
                          alpha, static_cast<cudaStream_t>(stream));                            \
  }

LIN_DEFINE_ENTRIES(float, f32)
LIN_DEFINE_ENTRIES(double, f64)
