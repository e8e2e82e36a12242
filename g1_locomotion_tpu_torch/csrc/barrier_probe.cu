// A measuring aid, not a kernel of the port: the cost of the dependent chains
// that bound the one-block kernels (B2, B3, B4 of lin_kernels.cu) at B = 1 and
// a warp of the Cholesky base kernel (B1).
//
// barrier_chain_kernel: each step of B2 / B3 / B4 passes values from one warp
// to all others through shared memory and one block barrier; this kernel does
// only that, `steps` times, in one block of `warps` warps, so time / steps is
// the least a step of such a chain can take on one SM.
//
// warp_chain_kernel: each column step of B1 passes values from one lane to
// the others of its warp through shared memory and one __syncwarp(); this
// kernel does only that, in one warp.
//
// cluster_chain_kernel: a kernel split over a two-CTA cluster that passed
// each step's pivot row from one warp of one CTA to both CTAs through
// distributed shared memory and one cluster barrier would pay this chain
// every step; this kernel does only that, with the owner alternating between
// the CTAs, so time / steps is the least such a step can take. (B3's cluster
// kernel, gj_cluster_kernel, does not pay it every step: it passes rows one
// way and meets its peer only where the row block's owner changes.)
//
// Build: as lin_kernels.cu (nvcc -shared, plain C interface, ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__global__ void barrier_chain_kernel(float* __restrict__ out, int steps) {
  __shared__ float buf[2][kWarp];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int warps = blockDim.y;
  float acc = static_cast<float>(lane);
  for (int j = 0; j < steps; ++j) {
    // The value stored depends on the value loaded in the step before.
    if (warp == j % warps) buf[j & 1][lane] = acc + 1.0f;
    __syncthreads();
    acc += buf[j & 1][lane];
  }
  out[warp * kWarp + lane] = acc;
}

__global__ void warp_chain_kernel(float* __restrict__ out, int steps) {
  __shared__ float buf[2][kWarp];
  const int lane = threadIdx.x;
  float acc = static_cast<float>(lane);
  for (int j = 0; j < steps; ++j) {
    // One lane stores what depends on its last load; every lane loads it.
    if (lane == j % kWarp) buf[j & 1][0] = acc + 1.0f;
    __syncwarp();
    acc += buf[j & 1][0];
  }
  out[lane] = acc;
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

__global__ void __cluster_dims__(2, 1, 1) cluster_chain_kernel(float* __restrict__ out,
                                                               int steps) {
  __shared__ float buf[2][kWarp];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int warps = blockDim.y;
  const unsigned rank = cluster_ctarank();
  const unsigned here = static_cast<unsigned>(__cvta_generic_to_shared(&buf[0][lane]));
  unsigned peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(peer) : "r"(here), "r"(rank ^ 1u));
  float acc = static_cast<float>(lane);
  cluster_sync();  // the peer has started: its shared memory may be written
  for (int j = 0; j < steps; ++j) {
    // The owner stores, here and in the peer, what depends on its last load.
    if (rank == static_cast<unsigned>(j & 1) && warp == (j >> 1) % warps) {
      const float v = acc + 1.0f;
      buf[j & 1][lane] = v;
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(peer + (j & 1) * 4 * kWarp), "f"(v)
                   : "memory");
    }
    cluster_sync();
    acc += buf[j & 1][lane];
  }
  cluster_sync();  // no CTA leaves while its peer may still write into it
  out[(rank * warps + warp) * kWarp + lane] = acc;
}

}  // namespace

// `out` holds warps * 32 floats. Returns a cudaError_t.
extern "C" int probe_barrier_chain(float* out, int steps, int warps, void* stream) {
  if (steps < 0 || warps < 1 || warps > 32) return cudaErrorInvalidValue;
  barrier_chain_kernel<<<1, dim3(kWarp, warps), 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                                         steps);
  return cudaGetLastError();
}

// `out` holds 32 floats. Returns a cudaError_t.
extern "C" int probe_warp_chain(float* out, int steps, void* stream) {
  if (steps < 0) return cudaErrorInvalidValue;
  warp_chain_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(out, steps);
  return cudaGetLastError();
}

// `out` holds 2 * warps * 32 floats. Returns a cudaError_t.
extern "C" int probe_cluster_chain(float* out, int steps, int warps, void* stream) {
  if (steps < 0 || warps < 1 || warps > 32) return cudaErrorInvalidValue;
  cluster_chain_kernel<<<2, dim3(kWarp, warps), 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                                         steps);
  return cudaGetLastError();
}
