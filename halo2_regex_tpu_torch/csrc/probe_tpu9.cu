// loop_floor and slab_scan -- the serial-loop probes of tools/probe_tpu9.py
// as H100 kernels: what one step of a serial loop costs on this card with
// its rows already in shared memory (loop_floor), and what the probe's
// table step costs, a chain of dependent shared-memory loads (slab_scan).
//
// loop_floor replaces the TPU kernels ka (A, tools/probe_tpu9.py:53,
// pallas_call at :62) and kb (B, :79, pallas_call at :92): o[i] = x[i] +
// o[i - 1] down the rows of x [L, TB] int32, one row a loop step (SLAB =
// 1) or eight (SLAB = 8: the eight rows are read before the eight adds).
// The sums wrap as JAX's int32 adds do (uint32_t here: signed overflow is
// undefined in C++).  The probes read x from VMEM, on-chip memory; here
// the rows of the next FLOOR_RING - 1 groups of eight are in flight to a
// shared-memory ring (probe_ring.cuh), so a step waits on the loop itself
// (a shared-memory read, the add, the store, the loop's own count and
// branch), not on device memory.
//
// slab_scan replaces kc (C, :120, pallas_call at :164): per step, the
// class of the byte c = x[i, b] (the probe's thresholds over classes[],
// which equal classes[c] for c in [0, 256), classes[0] below and
// classes[255] above), then v_j = tk[class, j * S + s] for j = 0..3 and
// s = v_0, from s = 0; eight rows a loop step.  The probe picks the
// columns with a one-hot bf16 product and a select: exact for table values
// in [0, S) (the wrapper's precondition), so this gather is the same
// function.
//
// What bounds them on the H100: latency, not bytes or operations.  One
// thread owns one column (a string) and walks its rows in order, blocks of
// 32 threads (bitplane_scan.cu's geometry: a warp an SM while there are
// fewer warps than SMs).  The loops are kept rolled (#pragma unroll 1).
// slab_scan's chain is one add and one shared-memory load a step (the
// class lookups and row bases of a slab's eight bytes hang off the chain),
// and each step also issues three more loads and four stores; its table
// [K, 4S] and class map sit in shared memory, its bytes come through the
// ring as loop_floor's rows do.  The times are the measurement: a step's
// cost is what the loop's structure leaves exposed.
//
// Layouts: x [L, TB] int32; o [L, TB] int32; tk [K, 4S] int32; classes
// [256] int32; slab_scan's four outputs [L, TB] int32.  L % 8 == 0 for
// slab_scan and for loop_floor's SLAB = 8.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int SCAN_SLAB = 8;  // probe C's SB: rows a group of the ring
constexpr int RING = 8;       // slab_scan's ring: groups of eight rows (RING - 1 in flight)
constexpr int FLOOR_RING = 16;  // loop_floor's: its steps are shorter, so more are in flight

template <int SLAB>
__global__ void __launch_bounds__(THREADS)
loop_floor_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int L, int TB) {
  __shared__ uint32_t ring[FLOOR_RING][SCAN_SLAB][THREADS];  // group p in slot p % FLOOR_RING
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= TB) return;
  auto fetch = [&](int p) {  // the rows of group p below L; an empty group past L
#pragma unroll
    for (int j = 0; j < SCAN_SLAB; ++j)
      if (p * SCAN_SLAB + j < L)
        probe_ring::copy4(&ring[p % FLOOR_RING][j][t],
                          x + (size_t)(p * SCAN_SLAB + j) * TB + b);
    probe_ring::commit();
  };
  for (int p = 0; p < FLOOR_RING - 1; ++p) fetch(p);
  uint32_t carry = 0;
#pragma unroll 1
  for (int i = 0; i < L; i += SLAB) {
    if (i % SCAN_SLAB == 0) {  // every step of SLAB = 8, every eighth of SLAB = 1
      fetch(i / SCAN_SLAB + FLOOR_RING - 1);  // into the slot that group p - 1 was read from
      probe_ring::wait_oldest<FLOOR_RING>();
    }
    const uint32_t* r = &ring[(i / SCAN_SLAB) % FLOOR_RING][i % SCAN_SLAB][t];
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      carry += r[j * THREADS];
      o[(size_t)(i + j) * TB + b] = (int32_t)carry;
    }
  }
  probe_ring::wait_all();
}

__global__ void __launch_bounds__(THREADS)
slab_scan_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ classes,
                 const int32_t* __restrict__ x, int32_t* __restrict__ o0,
                 int32_t* __restrict__ o1, int32_t* __restrict__ o2, int32_t* __restrict__ o3,
                 int L, int TB, int K, int S) {
  extern __shared__ int32_t smem[];
  int32_t* cmap = smem;        // [256]
  int32_t* tab = smem + 256;   // [K, 4S]
  __shared__ uint32_t ring[RING][SCAN_SLAB][THREADS];  // slab p's bytes in slot p % RING
  const int row = 4 * S;
  for (int i = threadIdx.x; i < 256; i += THREADS) cmap[i] = classes[i];
  for (int i = threadIdx.x; i < K * row; i += THREADS) tab[i] = tk[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= TB) return;
  const int n_slabs = L / SCAN_SLAB;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < n_slabs) {
#pragma unroll
      for (int j = 0; j < SCAN_SLAB; ++j)
        probe_ring::copy4(&ring[p % RING][j][t], x + (size_t)(p * SCAN_SLAB + j) * TB + b);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  int s = 0;
#pragma unroll 1
  for (int p = 0; p < n_slabs; ++p) {
    fetch(p + RING - 1);  // into slot (p - 1) % RING, read at p - 1
    probe_ring::wait_oldest<RING>();
    const int32_t* base[SCAN_SLAB];
#pragma unroll
    for (int j = 0; j < SCAN_SLAB; ++j)
      base[j] = tab + cmap[min(max((int)ring[p % RING][j][t], 0), 255)] * row;
#pragma unroll
    for (int j = 0; j < SCAN_SLAB; ++j) {
      const int32_t* r = base[j] + s;
      const int32_t v0 = r[0], v1 = r[S], v2 = r[2 * S], v3 = r[3 * S];
      s = v0;
      const size_t at = (size_t)(p * SCAN_SLAB + j) * TB + b;
      o0[at] = v0;
      o1[at] = v1;
      o2[at] = v2;
      o3[at] = v3;
    }
  }
  probe_ring::wait_all();
}

}  // namespace

extern "C" int h2r_loop_floor(const void* x, void* o, int slab, int L, int TB, void* stream) {
  const dim3 grid((TB + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (slab == 1)
    loop_floor_kernel<1><<<grid, THREADS, 0, st>>>((const int32_t*)x, (int32_t*)o, L, TB);
  else if (slab == 8 && L % 8 == 0)
    loop_floor_kernel<8><<<grid, THREADS, 0, st>>>((const int32_t*)x, (int32_t*)o, L, TB);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int h2r_slab_scan(const void* tk, const void* classes, const void* x, void* o0,
                             void* o1, void* o2, void* o3, int L, int TB, int K, int S,
                             void* stream) {
  if (L % SCAN_SLAB) return (int)cudaErrorInvalidValue;
  const size_t smem = (256 + (size_t)K * 4 * S) * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // no opt-in: the probe's is 9 KiB
  slab_scan_kernel<<<(TB + THREADS - 1) / THREADS, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tk, (const int32_t*)classes, (const int32_t*)x, (int32_t*)o0,
      (int32_t*)o1, (int32_t*)o2, (int32_t*)o3, L, TB, K, S);
  return (int)cudaGetLastError();
}
