// chains -- the issue-width probe of tools/probe_tpu56.py (A) as an H100
// kernel: C independent chains of n_steps steps of x = (x ^ (x << 1)) &
// (x >> 1) on 32-bit words, C = 1, 2 or 4.  If the time a step stays flat
// as C grows, a warp issues the chains' instructions side by side, and a
// serial scan has that much room for independent work.
//
// Replaces the TPU kernel made by make_chains_kernel (tools/probe_tpu56.py:61,
// pallas_call at :71).  As JAX's int32 ops: << wraps (done on uint32_t: a
// negative signed left shift is undefined before C++20) and >> is
// arithmetic (on int32_t, as nvcc does it).
//
// What bounds it on the H100: the chain's latency, a shift and a LOP3 a
// step, not bytes or operations.  One thread owns word w of every chain;
// the step loop is unrolled 4 times (the probe's unroll=4).  Two launch
// geometries: blocks of 32 threads (bitplane_scan.cu's: a warp an SM at
// 1024 words) or one block of 1024 threads (32 warps on one SM, sharing
// its four schedulers).
//
// Layouts: x and out [C, NW] int32 (the probe's (C, 8, 128): NW = 1024).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int C>
__global__ void __launch_bounds__(1024)
chains_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int NW, int n_steps) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= NW) return;
  int32_t v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = x[(size_t)j * NW + w];
#pragma unroll 4
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      v[j] = (int32_t)(((uint32_t)v[j] ^ ((uint32_t)v[j] << 1)) & (uint32_t)(v[j] >> 1));
  }
#pragma unroll
  for (int j = 0; j < C; ++j) out[(size_t)j * NW + w] = v[j];
}

}  // namespace

extern "C" int h2r_chains(const void* x, void* out, int C, int NW, int n_steps, int threads,
                          void* stream) {
  if (threads != 32 && threads != 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((NW + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  switch (C) {
    case 1: chains_kernel<1><<<grid, threads, 0, st>>>(xi, o, NW, n_steps); break;
    case 2: chains_kernel<2><<<grid, threads, 0, st>>>(xi, o, NW, n_steps); break;
    case 4: chains_kernel<4><<<grid, threads, 0, st>>>(xi, o, NW, n_steps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
