// What the chunked scans of loop_floor (probe_tpu9.cu) and the slab kernel
// (probe_slab.cuh) share: a ticket that hands out tiles in the order
// blocks ask, and relaxed loads and stores of the words the tiles
// publish for a decoupled look-back (Merrill and Garland).
//
// The scratch the wrapper keeps for each kernel, device and stream
// (ops/kernels.py `lookback_scratch`) starts with the ticket; the status
// words follow it, each tile's at an address fixed by the tile's index
// alone, so an address holds the same kind of word in every call, whatever
// the grid.  The ticket is back at 0 after every launch (take_ticket), so
// no launch needs it reset.  Every status word carries the call's epoch
// beside its value, in the same bits whichever call wrote it: a word of an
// earlier call is not ready, so the status needs no zero fill between
// calls.  A look-back reads a window of earlier tiles at once (kWindow;
// the slab kernel kSlabWindow), so that a round trip to L2 covers several
// tiles.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace probe_lookback {

constexpr int kTicketBytes = 256;  // the ticket, then the status words
constexpr int kWindow = 8;  // earlier tiles a look-back reads at once

// The tile this block owns: tickets in the order the blocks ask, so a
// tile's look-back only ever waits on tiles that running blocks hold.  A
// launch of n blocks raises the ticket n times by atomicInc(ticket, n - 1),
// which wraps it back to 0 after the last block.  All threads call it.
__device__ __forceinline__ uint32_t take_ticket(uint32_t* ticket) {
  __shared__ uint32_t t;
  if (threadIdx.x == 0) t = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  return t;
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

}  // namespace probe_lookback
