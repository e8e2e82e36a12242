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
#include <utility>

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
// (ops/lin.py). Column Cholesky with the diagonal clamped at 1e-30 and one
// reciprocal per column, then forward substitution on the identity. Only
// the lower triangle of K is used, as there.
//
// K and W are strided: element (b, r, c) lies at b * batch stride +
// r * row stride + c, so the kernel reads a block of a larger matrix where it
// lies and writes W into its place in the parent's W (the recursion makes no
// copies).
//
// What bounds it: a 30 x 30 block is 3.6 KB and 2 n^3 / 3 = 18 kflop; at
// B = 4096 the bytes (29.5 MB) take 0.009 ms at the card's memory rate, the
// operations less. In practice it is neither: the work is a chain of n
// dependent column steps, each a few dozen instructions for a warp, with 31
// matrices sharing an SM, and a block that lies inside a larger matrix is
// read and written as rows of n values that fill no whole 128-byte line.
// Design: one warp per matrix, n a compile-time constant, everything in
// registers, every loop unrolled. Lane t holds one array v[0..n): column t
// of the trailing matrix (so the load is
// one coalesced row per instruction, whatever the strides) until its own
// column is the pivot, and from then on minus the running sums of column t
// of W, acc[r] = sum_k L[r, k] W[k, t]: a lane needs the one before the
// pivot reaches it and the other after, so both updates are one
// multiply-add per entry with a multiplier of the lane's own. Step j:
//   lane j, which holds all of column j, publishes it as it is, with
//   rd = 1 / sqrt(max(a_jj, 1e-30)) in place of a_jj, to a shared-memory line
//   of 32 values (16-byte stores), and clears its own copy;
//   one __syncwarp(); every lane reads the line back (16-byte broadcast
//   loads, and its own entry a_tj);
//   W[j, t] is final and is stored at once (row j of W: one coalesced store):
//   rd in lane j, -acc[j] * rd in lanes t < j, exact zeros in lanes t > j;
//   v[k] -= a_kj * m for k > j, with m = a_tj * rd * rd in lanes t > j (the
//   right-looking Cholesky update, L[k, j] L[t, j]) and m = W[j, t] * rd in
//   lanes t <= j (the substitution, L[k, j] W[j, t]).
// L itself is never formed: a product with L[k, j] = a_kj * rd carries the rd
// in its other factor, which saves scaling the column. The lines are taken
// in turns (two per warp), so one __syncwarp() a step is enough. Each block
// holds a few warps (the caller's choice; it made no difference from 1 to 16
// on an H100). With 256 bytes of shared memory a matrix and 66 to 80
// registers a thread at float32 (n = 25 to 32), 24 of the 31 matrices that an
// SM gets at B = 4096 are resident at once and the rest follow as blocks
// retire.
// ---------------------------------------------------------------------------

// 16 bytes of T, moved with one instruction.
template <typename T>
struct alignas(16) Pack {
  static constexpr int E = 16 / sizeof(T);
  T v[E];
};

template <typename T, int N>
__global__ void chol_inv_base_kernel(const T* __restrict__ K, T* __restrict__ W, int batch,
                                     long long k_batch, long long k_row, long long w_batch,
                                     long long w_row) {
  constexpr int E = Pack<T>::E;
  constexpr int NP = (N + E - 1) / E * E;  // N rounded up to whole packs, <= 32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (b >= batch) return;  // a whole warp leaves together
  Pack<T>* lines = reinterpret_cast<Pack<T>*>(smem_raw) + threadIdx.y * 2 * (kWarp / E);
  const T* Kb = K + b * k_batch;
  T* Wb = W + b * w_batch;

  T v[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) v[k] = (k < N && lane < N) ? Kb[k * k_row + lane] : T(0);

#pragma unroll
  for (int j = 0; j < N; ++j) {
    Pack<T>* line = lines + (j & 1) * (kWarp / E);
    if (lane == j) {
      T d = v[j];
      d = sqrt(d < T(1e-30) ? T(1e-30) : d);  // NaN stays NaN
      v[j] = T(1) / d;
#pragma unroll
      for (int q = j / E; q < NP / E; ++q) {
        Pack<T> p;
#pragma unroll
        for (int e = 0; e < E; ++e) p.v[e] = v[q * E + e];  // entries k < j are not read
        line[q] = p;
      }
#pragma unroll
      for (int k = j + 1; k < N; ++k) v[k] = T(0);
    }
    __syncwarp();
    T col[NP];
#pragma unroll
    for (int q = j / E; q < NP / E; ++q) {
      const Pack<T> p = line[q];
#pragma unroll
      for (int e = 0; e < E; ++e) col[q * E + e] = p.v[e];
    }
    const T rd = col[j];
    // a_tj where t > j; the other lanes read a value they do not use.
    const T a_tj = reinterpret_cast<const T*>(line)[lane];
    const T w = lane == j ? rd : v[j] * rd;  // W[j, t] where t <= j
    const T m = (lane > j ? a_tj * rd : w) * rd;
    if (lane < N) Wb[j * w_row + lane] = lane > j ? T(0) : w;
#pragma unroll
    for (int k = j + 1; k < N; ++k) v[k] -= col[k] * m;
  }
}

template <typename T>
using CholInvBaseKernel = void (*)(const T*, T*, int, long long, long long, long long, long long);

template <typename T, int... Ns>
CholInvBaseKernel<T> chol_inv_base_for(int n, std::integer_sequence<int, Ns...>) {
  static const CholInvBaseKernel<T> table[] = {&chol_inv_base_kernel<T, Ns + 1>...};
  return table[n - 1];
}

// `warps` matrices share a block (1..32). Strides in elements.
template <typename T>
cudaError_t launch_chol_inv_base(const T* K, T* W, int batch, int n, long long k_batch,
                                 long long k_row, long long w_batch, long long w_row, int warps,
                                 cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || n > kWarp || warps < 1 || warps > kWarp) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * warps * 2 * kWarp;
  const dim3 block(kWarp, warps);
  const dim3 grid((batch + warps - 1) / warps);
  chol_inv_base_for<T>(n, std::make_integer_sequence<int, kWarp>{})<<<grid, block, smem, stream>>>(
      K, W, batch, k_batch, k_row, w_batch, w_row);
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
// Past the tile (B3 at float32, 208 < m <= 240: the serving MPC solve with
// MPCConfig.roll_moment_max has m = 210) one SM's registers cannot hold the
// system: 14 rows a thread would need 98 values and 16 factors under the 128
// registers a thread of a 512-thread block may have. gj_cluster_kernel
// splits the rows over the two SMs of a thread-block cluster (Hopper), each
// an 8 x 8 tile a thread, so that a step costs an SM at most 64
// multiply-adds a thread. What bounds it then is passing each pivot row to
// the other SM. A cluster barrier a step would do that at a round trip's
// cost: on an H100 the barrier probe's cluster chain (a store into the peer,
// a cluster barrier, a load) takes 0.71 us a step, more than the tile's
// whole step (PERF.md). But the rows of a row block of W pivots all come
// from the CTA that holds the block, and its peer only reads them: so the
// owner warp writes each normalised pivot row into a ring of W slots in both
// CTAs (in the peer with st.async, which completes on the slot's mbarrier
// there), the reader waits on that mbarrier, and each CTA keeps the tile's
// one block barrier a step for its own warps. The reader trails by one
// transfer, and the CTAs meet only where the owner changes, every W pivots.
// The ring needs no "empty" signal: the peer writes a slot again only for
// the block after next, which it cannot reach before this CTA has read every
// row of this block (each pivot row depends on all earlier ones). A step
// then costs about what the tile's does where its multiply-adds are few
// (PERF.md): the chain inside one SM (factors and row loaded, the next
// pivot's column and row updated, its reciprocal, published, a block
// barrier).
//
// gj_smem_kernel does the same arithmetic with the array in dynamic shared
// memory, one warp per row and three barriers per step, for float64 and for
// B2's float32 systems larger than its tile; no path of the port reaches it.
// ---------------------------------------------------------------------------

constexpr int kGjInverseW = 16;  // B2 tile: 16 warps, 8 x 4 a thread: 128 x 128
constexpr int kGjInverseR = 8;
constexpr int kGjInverseC = 4;
constexpr int kGjSolveW = 16;  // B3 tile: 16 warps, 13 x 7 a thread: 208 x 224 (with b)
constexpr int kGjSolveR = 13;
constexpr int kGjSolveC = 7;
// B3 cluster tile: 2 CTAs of 16 warps, 8 x 8 a thread: 256 x 256 (with b).
constexpr int kGjClusterCtas = 2;
constexpr int kGjClusterW = 16;
constexpr int kGjClusterR = 8;
constexpr int kGjClusterC = 8;
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

// Thread-block clusters (sm_90): this CTA's rank and its cluster's index in
// the grid, the address in distributed shared memory of the same shared
// variable in CTA `rank`, and the cluster barrier's two halves (arrive with
// release semantics, wait with acquire).
__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned map_to_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
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

// mbarrier (sm_90): init, the init's release to the cluster, an arrival
// that also expects `bytes` of asynchronous stores, a bounded wait for a
// phase's completion, and a 4-byte store into a peer CTA's shared memory
// that completes that many bytes on the peer's mbarrier.
__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(addr), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned addr, unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}" ::"r"(addr),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned addr, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(addr), "r"(parity)
      : "memory");
  return ok != 0;
}
// Clocks before a wait gives up (about 2 s): a row that never arrives traps
// (the launch fails) instead of hanging the card.
constexpr long long kMbarClocks = 4000000000LL;
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > kMbarClocks) __trap();
  }
}
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

// B3's tile split over a cluster of kGjClusterCtas CTAs of W warps: global
// row block g (rows W g .. W g + W - 1) lies in CTA g % 2, as its row block
// g / 2, so thread (ty, tx) of CTA `rank` holds in a[i][k] the element in row
// W (2 i + rank) + ty, column tx + 32 k. Every step is the tile's solve step,
// in the same order of operations per element (the results are bitwise the
// tile's); what differs is where a pivot row of the peer's block comes from:
// slot jj of a ring of W rows, one a pivot of the block, written by the
// peer's owner warp and awaited on the slot's mbarrier.
template <int W, int R, int C>
struct GjClusterTile {
  static constexpr int RP = round_up4(R);
  static constexpr int kColBytes = W * RP * 4;     // one buffer of published factors
  static constexpr int kRowBytes = kWarp * C * 4;  // one ring slot: a normalised pivot row
  float a[R][C];
  // Shared addresses: this warp's factors; this lane's entries of ring slot
  // 0, here and in the peer CTA; the mbarrier of slot 0, here and there
  // (8 bytes a slot).
  unsigned col, ring, peer_ring, full, peer_full;
  int tx, ty, rank;
  int kend;  // chunks that hold a column <= m; those beyond are zero padding

  // Pivot j = W * g + jj lies in column chunk chunk(g), lane lane(g, jj), in
  // the CTA for which holds(g). Constants where g is one (an unrolled loop),
  // but for holds.
  static __device__ __forceinline__ int chunk(int g) { return (g * W) / kWarp; }
  static __device__ __forceinline__ int lane(int g, int jj) { return (g * W) % kWarp + jj; }
  __device__ __forceinline__ bool holds(int g) const { return rank == g % kGjClusterCtas; }

  // Publish the factors of pivot (g, jj): its column in this CTA's rows.
  __device__ __forceinline__ void publish_col(int g, int jj, int buf) {
    const int kb = chunk(g);
    if (tx == lane(g, jj)) {
      const unsigned dst = col + buf * kColBytes;
#pragma unroll
      for (int i = 0; i + 4 <= R; i += 4) {
        sts128(dst + 4 * i, a[i][kb], a[i + 1][kb], a[i + 2][kb], a[i + 3][kb]);
      }
#pragma unroll
      for (int i = R / 4 * 4; i < R; ++i) sts32(dst + 4 * i, a[i][kb]);
    }
  }
  // Normalise pivot (g, jj)'s row in its owner warp and write it into ring
  // slot jj of both CTAs, from the pivot's chunk on (the chunks left of it
  // are dead): here with plain stores, there with stores that complete on the
  // peer's mbarrier of the slot.
  __device__ __forceinline__ void publish_row(int g, int jj, float piv) {
    const int i = g / kGjClusterCtas;
    const float inv = 1.0f / piv;
#pragma unroll
    for (int k = chunk(g); k < C; ++k) {
      if (k >= kend) break;
      a[i][k] = a[i][k] * inv;
      sts32(ring + jj * kRowBytes + 4 * kWarp * k, a[i][k]);
      st_async(peer_ring + jj * kRowBytes + 4 * kWarp * k, a[i][k], peer_full + 8 * jj);
    }
  }
  __device__ __forceinline__ float pivot_of(int g, int jj) {
    return __shfl_sync(kFullMask, a[g / kGjClusterCtas][chunk(g)], lane(g, jj));
  }
  // Step of pivot (g, jj), whose row is in ring slot jj; (gn, jjn) is the
  // next pivot. As the tile's step: the next pivot's column (every warp) and
  // row (its owner warp) first, published into the other factor buffer and
  // the next slot, then the rest of the update, and one block barrier.
  __device__ __forceinline__ void step(int g, int jj, int gn, int jjn, bool next) {
    const unsigned prow = ring + jj * kRowBytes;
    const int k0 = chunk(g);
    const int kbn = chunk(gn);
    const int in = gn / kGjClusterCtas;
    // A row of the peer's block: the k-th of the peer's blocks (g / 2) is
    // the slot's k-th phase.
    if (!holds(g)) mbar_wait(full + 8 * jj, (g / kGjClusterCtas) & 1);
    float f[RP];
#pragma unroll
    for (int q = 0; q < RP / 4; ++q) {
      const float4 v = lds128(col + (jj % kGjBufs) * kColBytes + 16 * q);
      f[4 * q] = v.x, f[4 * q + 1] = v.y, f[4 * q + 2] = v.z, f[4 * q + 3] = v.w;
    }
    if (holds(g) && ty == jj) f[g / kGjClusterCtas] = 0.0f;
    float p[C];
#pragma unroll
    for (int k = k0; k < C; ++k) {
      if (k >= kend) break;
      p[k] = lds32(prow + 4 * kWarp * k);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) a[i][kbn] -= f[i] * p[kbn];
    const bool owner = next && holds(gn) && ty == jjn;
    if (next) publish_col(gn, jjn, (jj + 1) % kGjBufs);
    if (owner) {
      const float piv = pivot_of(gn, jjn);
#pragma unroll
      for (int k = k0; k < C; ++k) {
        if (k >= kend) break;
        if (k != kbn) a[in][k] -= f[in] * p[k];
      }
      publish_row(gn, (jj + 1) % W, piv);
    }
#pragma unroll
    for (int k = k0; k < C; ++k) {
      if (k >= kend) break;
      if (k == kbn) continue;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!(owner && i == in)) a[i][k] -= f[i] * p[k];
      }
    }
    __syncthreads();
  }
};

template <int W, int R, int C>
__global__ void __cluster_dims__(kGjClusterCtas, 1, 1) __launch_bounds__(kWarp * W, 1)
    gj_cluster_kernel(const float* __restrict__ K, const float* __restrict__ rhs,
                      float* __restrict__ out, int m) {
  static_assert(kWarp % W == 0, "a row block lies in one column chunk");
  static_assert(W % kGjBufs == 0, "pivot j's factors lie in buffer (j % W) % kGjBufs");
  constexpr int G = kGjClusterCtas * R;  // global row blocks
  using Tile = GjClusterTile<W, R, C>;
  __shared__ float4 colbuf[kGjBufs][W * Tile::RP / 4];
  __shared__ float ring[W][kWarp * C];
  __shared__ unsigned long long fullbar[W];
  Tile t;
  t.tx = threadIdx.x;
  t.ty = threadIdx.y;
  t.rank = static_cast<int>(cluster_ctarank());
  const unsigned peer = static_cast<unsigned>(t.rank ^ 1);
  t.col = smem_addr(&colbuf[0][t.ty * (Tile::RP / 4)]);
  t.ring = smem_addr(&ring[0][t.tx]);
  t.peer_ring = map_to_rank(t.ring, peer);
  t.full = smem_addr(&fullbar[0]);
  t.peer_full = map_to_rank(t.full, peer);
  t.kend = (m + kWarp) / kWarp;
  const size_t b = cluster_id();
  const float* Kb = K + b * m * m;

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = W * (kGjClusterCtas * i + t.rank) + t.ty;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = t.tx + kWarp * k;
      float v = 0.0f;
      if (r < m) {
        if (c < m) {
          v = Kb[r * m + c];
        } else if (c == m) {
          v = rhs[b * m + r];
        }
      }
      t.a[i][k] = v;
    }
  }
  if (t.tx == 0 && t.ty == 0) {
    for (int s = 0; s < W; ++s) mbar_init(t.full + 8 * s, 1);
    fence_mbar_init();
  }
  // The peer has started and its mbarriers are set up.
  cluster_arrive();
  cluster_wait();
  {
    float piv = 0.0f;
    const bool owner = t.holds(0) && t.ty == 0;
    if (owner) piv = t.pivot_of(0, 0);
    t.publish_col(0, 0, 0);
    if (owner) t.publish_row(0, 0, piv);
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j0 = g * W;
    if (j0 >= m) break;
    // The peer's rows of this block: each slot expects the row's live chunks.
    if (!t.holds(g) && t.tx == 0 && t.ty == 0) {
      const unsigned bytes = 4u * kWarp * static_cast<unsigned>(t.kend - Tile::chunk(g));
      for (int s = 0; s < W && j0 + s < m; ++s) mbar_expect_tx(t.full + 8 * s, bytes);
    }
    for (int jj = 0; jj < W - 1; ++jj) {
      if (j0 + jj >= m) break;
      t.step(g, jj, g, jj + 1, j0 + jj + 1 < m);
    }
    const int j = j0 + W - 1;
    if (j < m) t.step(g, W - 1, g + 1 < G ? g + 1 : g, 0, j + 1 < m);
  }
  // No CTA leaves while its peer may still write into its shared memory.
  cluster_arrive();
  cluster_wait();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = W * (kGjClusterCtas * i + t.rank) + t.ty;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (r < m && t.tx + kWarp * k == m) out[b * m + r] = t.a[i][k];
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

// Which kernel launch_gj runs: ops/cuda_lin.py:gj_plan decides (GJ_ROUTES
// there), and a misfit is refused here.
enum GjRoute { kGjSmem = 0, kGjTile = 1, kGjCluster = 2 };

template <typename T, bool kSolve>
cudaError_t launch_gj(const T* K, const T* rhs, T* out, int batch, int m, int route,
                      cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (m < 1) return cudaErrorInvalidValue;
  if (route == kGjTile) {
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
  if (route == kGjCluster) {
    constexpr int W = kGjClusterW, R = kGjClusterR, C = kGjClusterC;
    if constexpr (kSolve && sizeof(T) == sizeof(float)) {
      if (m > kGjClusterCtas * W * R || m + 1 > kWarp * C) return cudaErrorInvalidValue;
      gj_cluster_kernel<W, R, C><<<kGjClusterCtas * batch, dim3(kWarp, W), 0, stream>>>(
          K, rhs, out, m);
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (route != kGjSmem) return cudaErrorInvalidValue;
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
// What bounds it: one instance is one block on one SM, and an iteration is
// three matrix-vector products that depend on each other, 2 (n^2 + 2 m n)
// flops: at n = 120, m = 200 a quarter of a microsecond at that SM's rate.
// K^-1 and A are read from device memory once (154 KB), which one SM takes
// more than a microsecond to pull in: the launch's fixed part. What an
// iteration costs in practice is the instructions every warp executes around
// its multiply-adds and the exchanges between warps, one per product.
//
// Design (admm_tile_kernel<RA>, float32 with n <= 128 and m <= 16 RA): K^-1
// and A live in registers for the whole launch. Warp ty, lane tx owns rows
// ty + 16 i and columns tx + 32 k of both: RA x 4 values of A, 8 x 4 of K^-1.
// RA = 13 (m <= 208) takes the MPC's and the WBID's QPs; RA = 14 (m <= 224)
// the MPC's with MPCConfig.roll_moment_max (m = 210), for 4 registers more a
// thread: a warp keeps the states of 16 rows (two lanes a row), so RA may
// grow to 16 with nothing else changed.
// Shared memory holds only vectors and partial sums. Per iteration:
//   A^T w: a thread sums its rows of A against w (its warp's RA entries),
//     and the 16 warps' partial sums of each column meet in shared memory;
//     after barrier 1 every thread adds up the 16 partials of its own four
//     columns (16-byte loads), so every warp has rhs. A^T is never stored.
//   K^-1 rhs: a thread sums its columns, the warp's lanes reduce (below),
//     and x~ of the warp's 8 rows goes to shared memory; barrier 2.
//   A x~: the same along the rows of A; the lanes reduce; then the warp
//     that owns a row updates z, y and w = rho z - y for it at once, with no
//     barrier: the row's z, y stay in that lane's registers, l, u, rho and
//     1 / rho (one division per launch) in the lane's own shared-memory slot.
// Two block barriers per iteration, one per exchange between warps; x is
// kept by every thread for its own columns. The lanes' reduction is a
// transposing one: V sums over 32 lanes are folded by halves, each lane
// keeping the half its lane bit selects, so lane t ends with the total of sum
// t / (32 / V) after V - 1 + log2(32 / V) shuffles, where V butterflies take
// 5 V and leave every lane with every sum, which nothing needs.
// Rows and columns beyond m and n are zero and stay zero.
//
// admm_smem_kernel keeps K^-1 and A in dynamic shared memory (153.6 KB at
// f32 for the MPC's size) with one warp per row and five barriers per
// iteration, for float64 and for sizes beyond the tiles; no path of the port
// reaches it. On an H100 its iteration took 14.3 us at m = 210 against the
// tile's 1.3 us at m = 200 (PERF.md): A^T w is a chain of m shared-memory
// multiply-adds in each of n threads.
// ---------------------------------------------------------------------------

constexpr int kAdmmW = 16;   // warps of the tile kernel
constexpr int kAdmmRA = 13;  // rows of A a thread: 16 x 13 = 208
constexpr int kAdmmRAWide = 14;  // the wide tile's: 16 x 14 = 224
constexpr int kAdmmRK = 8;   // rows of K^-1 a thread: 16 x 8 = 128
constexpr int kAdmmC = 4;    // columns a thread: 32 x 4 = 128
// Floats between two columns' partial sums (16 warps' and 4 of padding): the
// 16-byte loads of eight neighbouring lanes then fall in different banks.
constexpr int kAdmmPartLd = 20;
constexpr int kAdmmSmemWarps = 8;  // warps of admm_smem_kernel

// V sums spread over the warp's lanes, v[p] being this lane's part of sum p:
// returns, in lane t, the total of sum t / (32 / V). V is a power of two.
template <int V>
__device__ __forceinline__ float transpose_reduce(float (&v)[V], int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {  // lane bits 4..0
    const int off = (kWarp / 2) >> s;
    const int h = (V / 2) >> s;  // sums to fold at this bit; 0 once one is left
    if (h >= 1) {
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int p = 0; p < V / 2; ++p) {
        if (p < h) {
          const float keep = up ? v[p + h] : v[p];
          const float send = up ? v[p] : v[p + h];
          v[p] = keep + __shfl_xor_sync(kFullMask, send, off);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], off);
    }
  }
  return v[0];
}

template <int RA>
__global__ void __launch_bounds__(kWarp * kAdmmW, 1)
    admm_tile_kernel(const float* __restrict__ Kinv, const float* __restrict__ A,
                     const float* __restrict__ q, const float* __restrict__ l,
                     const float* __restrict__ u, const float* __restrict__ rho,
                     const float* __restrict__ x0, const float* __restrict__ z0,
                     const float* __restrict__ y0, float* __restrict__ xo,
                     float* __restrict__ zo, float* __restrict__ yo, int n, int m, int num,
                     float sigma, float alpha, float beta) {
  constexpr int W = kAdmmW, RK = kAdmmRK, C = kAdmmC;
  constexpr int kRowSlots = kWarp / 2;  // row states a warp keeps: lanes 2 i and 2 i + 1, row i
  static_assert(RA <= kRowSlots && kWarp % RK == 0, "rows map onto lanes");
  __shared__ float4 part[kWarp * C * kAdmmPartLd / 4];  // [column][warp]
  __shared__ float4 wbuf[W * kRowSlots / 4];            // [warp][row slot]: w = rho z - y
  __shared__ float xts[kWarp * C];                      // x~
  __shared__ float bounds[4][kWarp * W];                // l, u, rho, 1 / rho of a lane's row

  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t b = blockIdx.x;
  const float* Ab = A + b * m * n;
  const float* Kb = Kinv + b * n * n;

  float a[RA][C], ki[RK][C];
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = ty + W * i;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = tx + kWarp * k;
      a[i][k] = (r < m && c < n) ? Ab[r * n + c] : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = ty + W * i;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = tx + kWarp * k;
      ki[i][k] = (r < n && c < n) ? Kb[r * n + c] : 0.0f;
    }
  }
  float x[C], qv[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = tx + kWarp * k;
    x[k] = c < n ? x0[b * n + c] : 0.0f;
    qv[k] = c < n ? q[b * n + c] : 0.0f;
  }
  // The row this lane keeps: slot tx / 2 of its warp, row ty + 16 (tx / 2).
  const int slot = tx / 2;
  const int row = ty + W * slot;
  const bool has_row = slot < RA && row < m;
  float z = 0.0f, y = 0.0f;
  // This thread's own slot, which no other thread touches: no barrier.
  const unsigned bnd = smem_addr(&bounds[0][ty * kWarp + tx]);
  constexpr int kBound = 4 * kWarp * W;  // bytes from l to u to rho to 1 / rho
  {
    float lo = 0.0f, hi = 0.0f, rh = 1.0f;
    if (has_row) {
      z = z0[b * m + row], y = y0[b * m + row];
      lo = l[b * m + row], hi = u[b * m + row], rh = rho[b * m + row];
    }
    sts32(bnd, lo), sts32(bnd + kBound, hi), sts32(bnd + 2 * kBound, rh);
    sts32(bnd + 3 * kBound, 1.0f / rh);
  }
  const unsigned wdst = smem_addr(wbuf) + 4 * (ty * kRowSlots + slot);
  const unsigned wsrc = smem_addr(wbuf) + 4 * ty * kRowSlots;
  const unsigned pdst = smem_addr(part) + 4 * (tx * kAdmmPartLd + ty);
  const unsigned psrc = smem_addr(part) + 4 * tx * kAdmmPartLd;
  const unsigned xsrc = smem_addr(xts) + 4 * tx;
  const unsigned xdst = smem_addr(xts) + 4 * (ty + W * (tx / (kWarp / RK)));
  float wv = lds32(bnd + 2 * kBound) * z - y;

  for (int it = 0; it < num; ++it) {
    // A^T w: this thread's rows, then the 16 warps' partial sums.
    sts32(wdst, wv);
    __syncwarp();
    {
      float w[kRowSlots];
#pragma unroll
      for (int g = 0; g < (RA + 3) / 4; ++g) {
        const float4 t = lds128(wsrc + 16 * g);
        w[4 * g] = t.x, w[4 * g + 1] = t.y, w[4 * g + 2] = t.z, w[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float p = 0.0f;
#pragma unroll
        for (int i = 0; i < RA; ++i) p += a[i][k] * w[i];
        sts32(pdst + 4 * kWarp * kAdmmPartLd * k, p);
      }
    }
    __syncthreads();
    // rhs of this thread's columns, then x~ = K^-1 rhs for the warp's rows.
    {
      float rhs[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int g = 0; g < W / 4; ++g) {
          const float4 t = lds128(psrc + 4 * kWarp * kAdmmPartLd * k + 16 * g);
          s += (t.x + t.y) + (t.z + t.w);
        }
        rhs[k] = sigma * x[k] - qv[k] + s;
      }
      float v[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < C; ++k) s += ki[i][k] * rhs[k];
        v[i] = s;
      }
      const float xt = transpose_reduce<RK>(v, tx);
      if (tx % (kWarp / RK) == 0) sts32(xdst, xt);
    }
    __syncthreads();
    // z~ = A x~ for the warp's rows; the row's owner lanes update z, y, w.
    {
      float xt[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        xt[k] = lds32(xsrc + 4 * kWarp * k);
        x[k] = alpha * xt[k] + beta * x[k];
      }
      float v[kRowSlots];
#pragma unroll
      for (int i = 0; i < kRowSlots; ++i) {
        float s = 0.0f;
        if (i < RA) {
#pragma unroll
          for (int k = 0; k < C; ++k) s += a[i][k] * xt[k];
        }
        v[i] = s;
      }
      const float zt = transpose_reduce<kRowSlots>(v, tx);
      const float lo = lds32(bnd), hi = lds32(bnd + kBound);
      const float rh = lds32(bnd + 2 * kBound), rinv = lds32(bnd + 3 * kBound);
      const float za = alpha * zt + beta * z;
      float zn = za + y * rinv;
      zn = zn > lo ? zn : lo;
      zn = zn < hi ? zn : hi;
      y = y + rh * (za - zn);
      z = zn;
      wv = rh * z - y;
    }
  }

  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = tx + kWarp * k;
      if (c < n) xo[b * n + c] = x[k];
    }
  }
  if (has_row && tx % 2 == 0) {
    zo[b * m + row] = z;
    yo[b * m + row] = y;
  }
}

template <typename T>
__device__ void warp_matvec(const T* M, const T* v, T* out, int rows, int cols) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int r = warp; r < rows; r += kAdmmSmemWarps) {
    T acc = T(0);
    for (int c = lane; c < cols; c += kWarp) acc += M[r * cols + c] * v[c];
    for (int off = kWarp / 2; off > 0; off /= 2) acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) out[r] = acc;
  }
}

template <typename T>
__global__ void admm_smem_kernel(const T* __restrict__ Kinv, const T* __restrict__ A,
                                 const T* __restrict__ q, const T* __restrict__ l,
                                 const T* __restrict__ u, const T* __restrict__ rho,
                                 const T* __restrict__ x0, const T* __restrict__ z0,
                                 const T* __restrict__ y0, T* __restrict__ xo,
                                 T* __restrict__ zo, T* __restrict__ yo, int n, int m, int num,
                                 T sigma, T alpha, T beta) {
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

// `rows` picks the kernel: 0 admm_smem_kernel, kAdmmRA or kAdmmRAWide the
// register tile with that many rows of A a thread (float32 only, n and m
// within the tile). The caller decides (ops/cuda_lin.py:admm_plan,
// ADMM_ROUTES there) and a misfit is refused here.
template <typename T>
cudaError_t launch_admm(const T* Kinv, const T* A, const T* q, const T* l, const T* u,
                        const T* rho, const T* x, const T* z, const T* y, T* xo, T* zo, T* yo,
                        int batch, int n, int m, int num, double sigma, double alpha, int rows,
                        cudaStream_t stream) {
  if (batch <= 0) return cudaSuccess;
  if (n < 1 || m < 1 || num < 0) return cudaErrorInvalidValue;
  if (rows) {
    if constexpr (sizeof(T) == sizeof(float)) {
      if ((rows != kAdmmRA && rows != kAdmmRAWide) || n > kWarp * kAdmmC ||
          n > kAdmmW * kAdmmRK || m > kAdmmW * rows) {
        return cudaErrorInvalidValue;
      }
      const auto kernel =
          rows == kAdmmRA ? admm_tile_kernel<kAdmmRA> : admm_tile_kernel<kAdmmRAWide>;
      kernel<<<batch, dim3(kWarp, kAdmmW), 0, stream>>>(
          Kinv, A, q, l, u, rho, x, z, y, xo, zo, yo, n, m, num, static_cast<float>(sigma),
          static_cast<float>(alpha), static_cast<float>(1.0 - alpha));
      return cudaGetLastError();
    } else {
      return cudaErrorInvalidValue;
    }
  }
  const size_t smem = sizeof(T) * (static_cast<size_t>(n) * n + static_cast<size_t>(m) * n +
                                   4 * static_cast<size_t>(n) + 7 * static_cast<size_t>(m));
  static bool raised[kMaxDevices] = {};
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(&admm_smem_kernel<T>), smem, raised);
  if (err != cudaSuccess) return err;
  admm_smem_kernel<T><<<batch, kAdmmSmemWarps * kWarp, smem, stream>>>(
      Kinv, A, q, l, u, rho, x, z, y, xo, zo, yo, n, m, num, static_cast<T>(sigma),
      static_cast<T>(alpha), static_cast<T>(1.0 - alpha));
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (ctypes). Pointers are device pointers of contiguous
// row-major tensors (B1: of tensors with the given batch and row strides, in
// elements, and unit column stride); `stream` is a cudaStream_t. Returns a
// cudaError_t.
// ---------------------------------------------------------------------------

#define LIN_DEFINE_ENTRIES(T, SUFFIX)                                                           \
  extern "C" int lin_chol_inv_base_##SUFFIX(const T* K, T* W, int batch, int n,                \
                                            long long k_batch, long long k_row,                 \
                                            long long w_batch, long long w_row, int warps,      \
                                            void* stream) {                                     \
    return launch_chol_inv_base<T>(K, W, batch, n, k_batch, k_row, w_batch, w_row, warps,       \
                                   static_cast<cudaStream_t>(stream));                          \
  }                                                                                             \
  extern "C" int lin_gj_inverse_##SUFFIX(const T* K, T* out, int batch, int m, int route,      \
                                         void* stream) {                                        \
    return launch_gj<T, false>(K, nullptr, out, batch, m, route,                                \
                               static_cast<cudaStream_t>(stream));                              \
  }                                                                                             \
  extern "C" int lin_gj_solve_##SUFFIX(const T* K, const T* b, T* x, int batch, int m,         \
                                       int route, void* stream) {                               \
    return launch_gj<T, true>(K, b, x, batch, m, route, static_cast<cudaStream_t>(stream));    \
  }                                                                                             \
  extern "C" int lin_admm_iterate_##SUFFIX(                                                     \
      const T* Kinv, const T* A, const T* q, const T* l, const T* u, const T* rho, const T* x, \
      const T* z, const T* y, T* xo, T* zo, T* yo, int batch, int n, int m, int num,            \
      double sigma, double alpha, int rows, void* stream) {                                     \
    return launch_admm<T>(Kinv, A, q, l, u, rho, x, z, y, xo, zo, yo, batch, n, m, num, sigma,  \
                          alpha, rows, static_cast<cudaStream_t>(stream));                      \
  }

LIN_DEFINE_ENTRIES(float, f32)
LIN_DEFINE_ENTRIES(double, f64)
