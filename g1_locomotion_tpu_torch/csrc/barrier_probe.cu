// A measuring aid, not a kernel of the port: the cost of the dependent chain
// that bounds the Gauss-Jordan kernels (B2, B3 of lin_kernels.cu) at B = 1.
// Each of their m steps passes values from one warp to all others through
// shared memory and one block barrier; this kernel does only that, `steps`
// times, in one block of `warps` warps, so time / steps is the least a step
// of such a chain can take on one SM.
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

}  // namespace

// `out` holds warps * 32 floats. Returns a cudaError_t.
extern "C" int probe_barrier_chain(float* out, int steps, int warps, void* stream) {
  if (steps < 0 || warps < 1 || warps > 32) return cudaErrorInvalidValue;
  barrier_chain_kernel<<<1, dim3(kWarp, warps), 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                                         steps);
  return cudaGetLastError();
}
