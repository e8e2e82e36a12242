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

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared memory limit to the block maximum, once per
// kernel (each caller passes its own `raised` table) and device.
cudaError_t allow_smem(const void* kernel, size_t bytes, bool (&raised)[kMaxDevices]) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (raised[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  raised[device] = (err == cudaSuccess);
  return err;
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
  static bool raised[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&chol_inv_base_kernel<T>), smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 block(kWarp, kBaseMatsPerBlock);
  const dim3 grid((batch + kBaseMatsPerBlock - 1) / kBaseMatsPerBlock);
  chol_inv_base_kernel<T><<<grid, block, smem, stream>>>(K, W, batch, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2 / B3: unpivoted Gauss-Jordan elimination, in place.
//
// Replace g1_locomotion_tpu/ops/pallas_lin.py:gj_inverse (its inner
// `kernel`) and :gj_solve (_gj_solve_kernel): K^-1 of an SPD + ridge K, and
// x = S^-1 b. The pivots are taken in the same order as there, without
// pivoting: the systems are SPD + ridge (the QP's KKT matrix, the polish Hr
// and Schur complement), where that is stable. Do not use it on general
// matrices. Step j, on the m x w array (w = m for B2, m + 1 for B3 with b
// as the last column):
//   col = column j with its entry j set to 0;       (the factors)
//   B2 only: column j := e_j;                       (the inverse's column j
//                                                    takes the place of the
//                                                    eliminated column)
//   row j := row j * (1 / a_jj);                    (normalised pivot row)
//   every row r: row r -= col[r] * row j.
// After m steps the array holds K^-1 (B2), or x in its last column (B3).
// B3 touches only columns > j: a column left of the pivot is never read
// again. So B2 does m^3 multiply-adds on m x m values (no [K | I], half the
// work and half the memory of an augmented system), B3 m^3 / 2.
//
// What bounds it: at B = 1 one instance is one block on one SM, so the
// yardsticks are that SM's rates, 128 multiply-adds and four issues (one a
// scheduler) a clock, and the chain of m dependent steps, each of which
// must pass the pivot row and column from their owners to all warps through
// shared memory and a block barrier. The card's memory rate and its other
// 131 SMs do not enter: the matrix is read from device memory once and the
// result written once.
//
// Design (gj_tile_kernel, float32 up to the tile's size): the matrix lives
// in registers. Warp ty, lane tx owns rows ty + W * i and columns
// tx + 32 * k, an R x C tile, so a step costs a thread about R / 4 + C
// shared-memory loads (its factors, 16 bytes at a time, and its pivot-row
// entries) for R * C multiply-adds, where a matrix kept in shared memory
// costs three accesses per multiply-add. Register tiles need constant
// indices: the step loop is unrolled over the row block i of the pivot,
// which also fixes the pivot's column chunk k, and B3 starts its update at
// that chunk (the dead chunks cost nothing). One barrier per step: each
// step first brings the next pivot's column (every warp) and row (its owner
// warp) up to date, and their owners publish them to shared memory straight
// from their registers, into the buffer the step is not reading; the rest
// of the tile is updated behind that, and the barrier ends the step. What a
// step costs beyond its multiply-adds is the instructions around them, in
// every warp: keep them few. Rows and columns beyond m are zero and are
// never pivots, so padding cannot make a zero pivot.
//
// gj_smem_kernel does the same arithmetic with the array in dynamic shared
// memory, one warp per row and three barriers per step, for float64 and for
// float32 systems larger than the tile. The main path does not reach it.
// ---------------------------------------------------------------------------

constexpr int kGjInverseW = 16;  // B2 tile: 16 warps, 8 x 4 a thread: 128 x 128
constexpr int kGjInverseR = 8;
constexpr int kGjInverseC = 4;
constexpr int kGjSolveW = 16;  // B3 tile: 16 warps, 13 x 7 a thread: 208 x 224 (with b)
constexpr int kGjSolveR = 13;
constexpr int kGjSolveC = 7;
constexpr int kGjSmemWarps = 16;  // gj_smem_kernel
// Buffers for the published pivots, taken in turns: step j reads pivot j's
// while it publishes pivot j + 1's, with one barrier between steps.
constexpr int kGjBufs = 2;

__host__ __device__ constexpr int round_up4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
// Accesses at a 32-bit shared address that is worked out once: through a
// pointer the compiler rebuilds the address at every access.
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float lds32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void sts128(unsigned addr, float x, float y, float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "f"(x), "f"(y), "f"(z),
               "f"(w)
               : "memory");
}

// The register tile of one thread, W warps a block: a[i][k] is the element in
// row ty + W * i, column tx + 32 * k. The published factors lie warp by warp
// (float ty * RP + i of a column buffer), so that a thread reads its own 16
// bytes at a time; the published pivot row lies as the row does (float
// tx + 32 * k of a row buffer), read one chunk at a time to keep few of its
// values in registers at once.
template <bool kSolve, int W, int R, int C>
struct GjTile {
  static constexpr int RP = round_up4(R);
  static constexpr int kColBytes = W * RP * 4;     // one buffer of published factors
  static constexpr int kRowBytes = kWarp * C * 4;  // one of the normalised pivot row
  float a[R][C];
  unsigned col, row;  // shared addresses of this warp's factors, this lane's row entries
  int tx, ty;

  // Pivot j = W * ib + jj lies in column chunk chunk(ib), lane lane(ib, jj).
  // Both are constants where ib is one (an unrolled loop).
  static __device__ __forceinline__ int chunk(int ib) { return (ib * W) / kWarp; }
  static __device__ __forceinline__ int lane(int ib, int jj) { return (ib * W) % kWarp + jj; }

  // Publish pivot (ib, jj)'s column, which its owners hold up to date: the
  // factors of the step. For the inverse the owners clear it afterwards
  // (clear_col), so that the step leaves column j of the inverse there.
  __device__ __forceinline__ void publish_col(int ib, int jj, int buf) {
    const int kb = chunk(ib);
    if (tx == lane(ib, jj)) {
      // One lane a warp stores, so each store is a turn of the SM's one
      // shared-memory pipe whatever its width: 16 bytes at a time.
      const unsigned dst = col + buf * kColBytes;
#pragma unroll
      for (int i = 0; i + 4 <= R; i += 4) {
        sts128(dst + 4 * i, a[i][kb], a[i + 1][kb], a[i + 2][kb], a[i + 3][kb]);
      }
#pragma unroll
      for (int i = R / 4 * 4; i < R; ++i) sts32(dst + 4 * i, a[i][kb]);
    }
  }
  __device__ __forceinline__ void clear_col(int ib, int jj) {
    const int kb = chunk(ib);
    if (!kSolve && tx == lane(ib, jj)) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!(i == ib && ty == jj)) a[i][kb] = 0.0f;  // the pivot's place holds 1 / pivot
      }
    }
  }

  // Normalise and publish pivot (ib, jj)'s row, in its owner warp; `piv` is
  // the pivot. The inverse puts 1 / pivot where the pivot was. The solve
  // leaves the chunks left of the pivot's as they are: no step reads them
  // again.
  __device__ __forceinline__ void publish_row(int ib, int jj, int buf, float piv) {
    const int kb = chunk(ib);
    const int k0 = kSolve ? kb : 0;
    const float inv = 1.0f / piv;
#pragma unroll
    for (int k = k0; k < C; ++k) {
      const bool pivot = !kSolve && k == kb && tx == lane(ib, jj);
      a[ib][k] = pivot ? inv : a[ib][k] * inv;
      sts32(row + buf * kRowBytes + 4 * kWarp * k, a[ib][k]);
    }
  }

  __device__ __forceinline__ float pivot_of(int ib, int jj) {
    return __shfl_sync(kFullMask, a[ib][chunk(ib)], lane(ib, jj));
  }

  // Step of pivot (ib, jj), which is published in buffer jj % kGjBufs:
  // subtract factor * pivot row from every row, in an order that brings the
  // next pivot's column and (in its owner warp) row up to date first; their
  // owners publish them (if `next`) before the warp updates the rest of its
  // tile, and one barrier ends the step. (ibn, jjn) is the next pivot.
  __device__ __forceinline__ void step(int ib, int jj, int ibn, int jjn, bool next) {
    const unsigned prow = row + (jj % kGjBufs) * kRowBytes;
    const int bufn = (jj + 1) % kGjBufs;
    const int k0 = kSolve ? chunk(ib) : 0;
    const int kbn = chunk(ibn);
    float f[RP];
#pragma unroll
    for (int q = 0; q < RP / 4; ++q) {
      const float4 v = lds128(col + (jj % kGjBufs) * kColBytes + 16 * q);
      f[4 * q] = v.x, f[4 * q + 1] = v.y, f[4 * q + 2] = v.z, f[4 * q + 3] = v.w;
    }
    if (ty == jj) f[ib] = 0.0f;  // the pivot row itself stays as normalised
    const float pn = lds32(prow + 4 * kWarp * kbn);
#pragma unroll
    for (int i = 0; i < R; ++i) a[i][kbn] -= f[i] * pn;
    const bool owner = next && ty == jjn;
    if (next) publish_col(ibn, jjn, bufn);
    if (owner) {
      const float piv = pivot_of(ibn, jjn);
#pragma unroll
      for (int k = k0; k < C; ++k) {
        if (k != kbn) a[ibn][k] -= f[ibn] * lds32(prow + 4 * kWarp * k);
      }
      publish_row(ibn, jjn, bufn, piv);
    }
    if (next) clear_col(ibn, jjn);
#pragma unroll
    for (int k = k0; k < C; ++k) {
      if (k == kbn) continue;
      const float pk = lds32(prow + 4 * kWarp * k);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!(owner && i == ibn)) a[i][k] -= f[i] * pk;
      }
    }
    __syncthreads();
  }
};

template <bool kSolve, int W, int R, int C>
__global__ void __launch_bounds__(kWarp * W, 1)
    gj_tile_kernel(const float* __restrict__ K, const float* __restrict__ rhs,
                   float* __restrict__ out, int m) {
  static_assert(kWarp % W == 0, "a row block lies in one column chunk");
  static_assert(W % kGjBufs == 0, "pivot j lies in buffer (j % W) % kGjBufs");
  using Tile = GjTile<kSolve, W, R, C>;
  __shared__ float4 colbuf[kGjBufs][W * Tile::RP / 4];
  __shared__ float rowbuf[kGjBufs][kWarp * C];
  Tile t;
  t.tx = threadIdx.x;
  t.ty = threadIdx.y;
  t.col = smem_addr(&colbuf[0][t.ty * (Tile::RP / 4)]);
  t.row = smem_addr(&rowbuf[0][t.tx]);
  const size_t b = blockIdx.x;
  const float* Kb = K + b * m * m;

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = t.ty + W * i;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t.tx + kWarp * k;
      float v = 0.0f;
      if (r < m) {
        if (c < m) {
          v = Kb[r * m + c];
        } else if (kSolve && c == m) {
          v = rhs[b * m + r];
        }
      }
      t.a[i][k] = v;
    }
  }

  {
    float piv = 0.0f;
    if (t.ty == 0) piv = t.pivot_of(0, 0);
    t.publish_col(0, 0, 0);
    if (t.ty == 0) t.publish_row(0, 0, 0, piv);
    t.clear_col(0, 0);
    __syncthreads();
  }
#pragma unroll
  for (int ib = 0; ib < R; ++ib) {
    const int j0 = ib * W;
    for (int jj = 0; jj < W - 1; ++jj) {
      if (j0 + jj >= m) break;
      t.step(ib, jj, ib, jj + 1, j0 + jj + 1 < m);
    }
    // The block's last pivot hands over to the next block's first.
    const int j = j0 + W - 1;
    if (j < m) t.step(ib, W - 1, ib + 1 < R ? ib + 1 : ib, 0, j + 1 < m);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = t.ty + W * i;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t.tx + kWarp * k;
      if (kSolve) {
        if (r < m && c == m) out[b * m + r] = t.a[i][k];
      } else {
        if (r < m && c < m) out[b * m * m + r * m + c] = t.a[i][k];
      }
    }
  }
}

template <typename T, bool kSolve>
__global__ void gj_smem_kernel(const T* __restrict__ K, const T* __restrict__ rhs,
                               T* __restrict__ out, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = kSolve ? m + 1 : m;
  T* arr = reinterpret_cast<T*>(smem_raw);  // (m, w)
  T* col = arr + m * w;                     // (m)
  const size_t b = blockIdx.x;
  const int tid = threadIdx.y * kWarp + threadIdx.x;
  const int nthreads = kWarp * kGjSmemWarps;

  for (int idx = tid; idx < m * w; idx += nthreads) {
    const int r = idx / w;
    const int c = idx % w;
    arr[idx] = c < m ? K[b * m * m + r * m + c] : rhs[b * m + r];
  }
  __syncthreads();

  for (int j = 0; j < m; ++j) {
    const int c0 = kSolve ? j + 1 : 0;
    T* prow = arr + j * w;
    const T inv = T(1) / prow[j];
    for (int r = tid; r < m; r += nthreads) col[r] = (r == j) ? T(0) : arr[r * w + j];
    __syncthreads();
    for (int c = c0 + tid; c < w; c += nthreads) {
      prow[c] = (!kSolve && c == j) ? inv : prow[c] * inv;
    }
    __syncthreads();
    for (int r = threadIdx.y; r < m; r += kGjSmemWarps) {
      if (r == j) continue;
      const T f = col[r];
      T* row = arr + r * w;
      for (int c = c0 + threadIdx.x; c < w; c += kWarp) {
        const T v = (!kSolve && c == j) ? T(0) : row[c];
        row[c] = v - f * prow[c];
      }
    }
    __syncthreads();
  }

  if (kSolve) {
    for (int r = tid; r < m; r += nthreads) out[b * m + r] = arr[r * w + m];
  } else {
    for (int idx = tid; idx < m * m; idx += nthreads) out[b * m * m + idx] = arr[idx];
  }
}

// `tile` picks the register-tile kernel (float32 only, m within the tile);
// the caller decides (ops/cuda_lin.py:gj_plan) and a misfit is refused here.
template <typename T, bool kSolve>
cudaError_t launch_gj(const T* K, const T* rhs, T* out, int batch, int m, int tile,
                      cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (m < 1) return cudaErrorInvalidValue;
  if (tile) {
    constexpr int W = kSolve ? kGjSolveW : kGjInverseW;
    constexpr int R = kSolve ? kGjSolveR : kGjInverseR;
    constexpr int C = kSolve ? kGjSolveC : kGjInverseC;
    if constexpr (sizeof(T) == sizeof(float)) {
      if (m > W * R || m + (kSolve ? 1 : 0) > kWarp * C) return cudaErrorInvalidValue;
      gj_tile_kernel<kSolve, W, R, C><<<batch, dim3(kWarp, W), 0, stream>>>(K, rhs, out, m);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const dim3 block(kWarp, kGjSmemWarps);
  const size_t w = kSolve ? m + 1 : static_cast<size_t>(m);
  const size_t smem = sizeof(T) * (m * w + m);
  static bool raised[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&gj_smem_kernel<T, kSolve>), smem, raised);
  if (err != cudaSuccess) return err;
  gj_smem_kernel<T, kSolve><<<batch, block, smem, stream>>>(K, rhs, out, m);
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
  static bool raised[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&admm_kernel<T>), smem, raised);
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
  extern "C" int lin_gj_inverse_##SUFFIX(const T* K, T* out, int batch, int m, int tile,       \
                                         void* stream) {                                        \
    return launch_gj<T, false>(K, nullptr, out, batch, m, tile,                                 \
                               static_cast<cudaStream_t>(stream));                              \
  }                                                                                             \
  extern "C" int lin_gj_solve_##SUFFIX(const T* K, const T* b, T* x, int batch, int m,         \
                                       int tile, void* stream) {                                \
    return launch_gj<T, true>(K, b, x, batch, m, tile, static_cast<cudaStream_t>(stream));     \
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
