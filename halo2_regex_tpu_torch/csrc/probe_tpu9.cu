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
// function.  Its kernel is probe_slab.cuh's slab_kernel<4> from state 0.
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
#include "probe_slab.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int SCAN_SLAB = 8;  // rows a group of loop_floor's ring (probe C's SB)
constexpr int FLOOR_RING = 16;  // groups in flight: its steps are short

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
  void* const outs[4] = {o0, o1, o2, o3};
  return probe_slab::launch<4>(tk, classes, x, outs, L, TB, K, S, 0, (cudaStream_t)stream);
}
