// The slab kernel's table step, shared by slab_scan (probe_tpu9.cu: four
// picks and four stores a step, from state 0) and slab_anatomy
// (probe_tpu18.cu: N_OUT = 1, 2 or 4 picks and stores a step, from the
// model's first state).
//
// Per step: the class of the byte c = x[i, b] (classes[c], the clamped
// c taking the class of 0 or 255, as the probes' thresholds give it), then
// v_j = tk[class, j * S + s] for j < N_OUT and s = v_0.  One thread owns
// one column (a string) and walks its rows in order, blocks of 32 threads;
// the table [K, 4S] and the class map sit in shared memory, the bytes
// come through probe_ring.cuh's ring eight rows a group.  The chain is one
// add and one shared-memory load a step; the other N_OUT - 1 loads and
// the N_OUT stores hang off it.
//
// Layouts: tk [K, 4S] int32; classes [256] int32; x [L, TB] int32 and
// each output [L, TB] int32, L % 8 == 0.  The table and class map take
// (256 + 4 K S) * 4 bytes of dynamic shared memory: past 48 KiB the launch
// opts in, up to the card's limit (probe_tpu6's k3, P4 [256, 128] with the
// identity class map, is slab_anatomy<2>).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace probe_slab {
namespace {  // internal linkage: each source that includes it has its own copy

constexpr int THREADS = 32;
constexpr int SLAB = 8;  // rows a group of the ring (the probes' SLAB)
constexpr int RING = 8;  // groups of eight rows (RING - 1 in flight)

template <int N_OUT>
struct Outs {
  int32_t* o[N_OUT];
};

template <int N_OUT>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ classes,
            const int32_t* __restrict__ x, Outs<N_OUT> outs, int L, int TB, int K, int S,
            int first) {
  extern __shared__ int32_t smem[];
  int32_t* cmap = smem;        // [256]
  int32_t* tab = smem + 256;   // [K, 4S]
  __shared__ uint32_t ring[RING][SLAB][THREADS];  // slab p's bytes in slot p % RING
  const int row = 4 * S;
  for (int i = threadIdx.x; i < 256; i += THREADS) cmap[i] = classes[i];
  for (int i = threadIdx.x; i < K * row; i += THREADS) tab[i] = tk[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= TB) return;
  const int n_slabs = L / SLAB;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < n_slabs) {
#pragma unroll
      for (int j = 0; j < SLAB; ++j)
        probe_ring::copy4(&ring[p % RING][j][t], x + (size_t)(p * SLAB + j) * TB + b);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  int s = first;
#pragma unroll 1
  for (int p = 0; p < n_slabs; ++p) {
    fetch(p + RING - 1);  // into slot (p - 1) % RING, read at p - 1
    probe_ring::wait_oldest<RING>();
    const int32_t* base[SLAB];
#pragma unroll
    for (int j = 0; j < SLAB; ++j)
      base[j] = tab + cmap[min(max((int)ring[p % RING][j][t], 0), 255)] * row;
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      const int32_t* r = base[j] + s;
      int32_t v[N_OUT];
#pragma unroll
      for (int o = 0; o < N_OUT; ++o) v[o] = r[o * S];
      s = v[0];
      const size_t at = (size_t)(p * SLAB + j) * TB + b;
#pragma unroll
      for (int o = 0; o < N_OUT; ++o) outs.o[o][at] = v[o];
    }
  }
  probe_ring::wait_all();
}

// Launch slab_kernel<N_OUT> on outs[0..N_OUT); a cudaError code.
template <int N_OUT>
int launch(const void* tk, const void* classes, const void* x, void* const* outs, int L,
           int TB, int K, int S, int first, cudaStream_t st) {
  if (L % SLAB) return (int)cudaErrorInvalidValue;
  const size_t smem = (256 + (size_t)K * 4 * S) * sizeof(int32_t);
  // past the 48 KiB default, up to the card's opt-in less the static ring
  // (probe_tpu6's k3: a [256, 128] table, 132 KiB)
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (smem + sizeof(uint32_t) * RING * SLAB * THREADS > (size_t)optin)
      return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(slab_kernel<N_OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Outs<N_OUT> o;
  for (int j = 0; j < N_OUT; ++j) o.o[j] = (int32_t*)outs[j];
  slab_kernel<N_OUT><<<(TB + THREADS - 1) / THREADS, THREADS, smem, st>>>(
      (const int32_t*)tk, (const int32_t*)classes, (const int32_t*)x, o, L, TB, K, S, first);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace probe_slab
