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
// One thread owns word w of every chain; the step loop is unrolled 4 times
// (the probe's unroll=4).  Two launch geometries: blocks of 32 threads
// (bitplane_scan.cu's: a warp an SM at 1024 words) or one block of 1024
// threads (32 warps on one SM, sharing its four schedulers).  Two forms:
//
// - serial: every thread runs all n_steps steps.  What bounds it: the
//   chain's latency, a shift and a LOP3 a step, not bytes or operations;
//   this is the form that measures the issue width.
// - fixed: after each group of 4 steps a thread also computes f once more;
//   where f(v) = v for every word of the warp (__all_sync), every later
//   step is the identity, so the warp stops and its outputs are v, exactly
//   f^n_steps(x).  A word that never reaches a fixed point, and every word
//   when n_steps is below the exit, runs all n_steps steps (the last
//   n_steps % 4 after the groups, unchecked).  Lanes past NW hold 0, a
//   fixed point.  Lane 0 of each warp writes the steps it ran into the
//   warp's slot of steps[] (every warp of the grid has one, so nothing
//   needs zeroing); the most of them is the most any warp ran.
//
// Layouts: x and out [C, NW] int32 (the probe's (C, 8, 128): NW = 1024).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int32_t step(int32_t v) {
  return (int32_t)(((uint32_t)v ^ ((uint32_t)v << 1)) & (uint32_t)(v >> 1));
}

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
    for (int j = 0; j < C; ++j) v[j] = step(v[j]);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) out[(size_t)j * NW + w] = v[j];
}

template <int C>
__global__ void __launch_bounds__(1024)
chains_fixed_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int NW,
                    int n_steps, int32_t* __restrict__ steps) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < NW;  // the whole warp stays for __all_sync
  int32_t v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = live ? x[(size_t)j * NW + w] : 0;
  int i = 0;
  bool fixed = false;
#pragma unroll 1
  while (i + 4 <= n_steps) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = step(v[j]);
    }
    i += 4;
    bool same = true;
#pragma unroll
    for (int j = 0; j < C; ++j) same &= step(v[j]) == v[j];
    if (__all_sync(0xFFFFFFFFu, same)) {
      fixed = true;
      break;
    }
  }
  if (!fixed) {
    for (; i < n_steps; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = step(v[j]);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < C; ++j) out[(size_t)j * NW + w] = v[j];
  }
  if ((threadIdx.x & 31) == 0) steps[(blockIdx.x * blockDim.x + threadIdx.x) >> 5] = i;
}

template <int C>
void launch(const int32_t* x, int32_t* out, int NW, int n_steps, int threads,
            int32_t* steps, cudaStream_t st) {
  const dim3 grid((NW + threads - 1) / threads);
  if (steps)
    chains_fixed_kernel<C><<<grid, threads, 0, st>>>(x, out, NW, n_steps, steps);
  else
    chains_kernel<C><<<grid, threads, 0, st>>>(x, out, NW, n_steps);
}

}  // namespace

// steps null: the serial form; else the fixed form, the steps each warp
// ran into steps[ceil(NW / threads) * threads / 32] (int32)
extern "C" int h2r_chains(const void* x, void* out, int C, int NW, int n_steps, int threads,
                          void* steps, void* stream) {
  if (threads != 32 && threads != 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* xi = (const int32_t*)x;
  int32_t* o = (int32_t*)out;
  int32_t* sm = (int32_t*)steps;
  switch (C) {
    case 1: launch<1>(xi, o, NW, n_steps, threads, sm, st); break;
    case 2: launch<2>(xi, o, NW, n_steps, threads, sm, st); break;
    case 4: launch<4>(xi, o, NW, n_steps, threads, sm, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
