// The probes' input ring (loop_floor, slab_scan, bitop_scan): each thread copies its
// own words of the next RING - 1 steps into shared memory with cp.async,
// one commit group a step, and waits only for the oldest group, as
// bitplane_scan.cu does.  cp.async writes no register, so no copy in
// flight holds a register that the serial chain waits on.  (Loads into
// registers a step or four slabs ahead, the first designs, measured a
// device-memory wait in every step on an H100: about 1000 cycles a step
// for bitop_scan, 170 for slab_scan.)

#pragma once

#include <cstdint>

namespace probe_ring {

__device__ __forceinline__ void copy4(uint32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// the same to a shared-memory address (a caller that keeps addresses, not pointers)
__device__ __forceinline__ void copy4(uint32_t dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// at most RING - 2 groups pending: the oldest of the RING - 1 in flight has landed
template <int RING>
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
}

// at most N groups pending
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

}  // namespace probe_ring
