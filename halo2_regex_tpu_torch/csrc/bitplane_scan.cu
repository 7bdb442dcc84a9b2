// K2: scan -- the serial DFA recurrence of every def, in three builds:
//   scan (entry h2r_scan): the pack's planes in, every def's log planes out;
//   scan_fpack (the generated header sets H2R_SCAN_FUSED_PACK, entry
//     h2r_scan_fpack): the raw quad rows in, the byte-bit planes extracted
//     here (no pack kernel);
//   scan_def (the header is one def's, and sets H2R_SCAN_DEF, entry
//     h2r_scan_def): one def alone, reading its planes from the whole
//     stack.
//
// Replaces the TPU kernels BitplaneMatcher._make_scan_fused
// (halo2_regex_tpu/ops/bitplane.py:934, pallas_call at :1013), with its
// fused_pack prologue (:947-958) for scan_fpack, and
// BitplaneMatcher._make_scan (:836, pallas_call at :904; the scan_planes
// profiling hook) for scan_def.
//
// What bounds it on the H100: latency.  One thread owns one word (32
// strings) and walks all L positions in order; each position runs the
// generated step circuit of every def (240 dependent-chain ops for the
// zk-email from: model with the binary class stage; the class BDD adds
// its ops to the chain when the class stage is off) on one-hot live-state
// planes held in registers.  At B = 32768 there are only NW = 1024
// threads: 32 warps, one on each of 32 SMs, each issuing from one
// scheduler.  The recurrence is serial per string, so the kernel's time
// is one warp's time per position times L; what a warp waits on is either
// the circuit's instructions or its input loads.  Loading position l + 1 while l
// computes (an earlier design) left most of a device-memory latency
// exposed at every step: 882 cycles a position on an H100 for the from:
// model, against 197 for the same loop reading its input from shared
// memory.
//
// What the design does about it: the input planes of the next RING - 1
// positions are kept in flight.  Each thread copies its own words of a
// position (KIN words, 4 bytes each, coalesced over the warp) into its
// slot of a shared-memory ring with cp.async, one commit group per
// position, RING - 1 positions ahead of the one it computes, and waits
// only for the oldest group; a slot is refilled one position after it was
// read.  No thread reads another's words, so no barrier is needed.
// (Copying a position's rows warp-cooperatively in 16-byte pieces, one
// copy a lane and a __syncwarp a position, measured slower on an H100 at
// B = 32768, 0.2621 against 0.2019 ms: its loop compiled to 1608 SASS
// instructions against 1032.)  The position loop is unrolled
// H2R_SCAN_UNROLL times (the unroll knob) so the warp can interleave
// neighbouring positions' stores and loop work; the one-hot states never
// leave registers, and one thread's loop covers all of L, so no carry
// passes between blocks (the TPU grid carried them through VMEM scratch
// between L-chunks).  Blocks of 32 threads spread the
// warps over as many SMs as there are warps.  Log-plane writes are
// coalesced over words.  scan_fpack needs no scratch for its planes (the
// TPU kernel staged a chunk's in VMEM): a word's 8 byte-bit planes at a
// position depend only on its own 8 quad words m = 0..7, which the thread
// copies as it would copy 8 class planes.
//
// Layouts: bits [L, KP, NWS, 128] int32 (scan_fpack: the raw quad rows
// [L, 8, NWS, 128], word w of row (l, m) holding bytes s = 0..3 of strings
// 4 * (w + NW * m) + s at position l); logs [NWS, SB_SUM, L, 128] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

#ifndef H2R_SCAN_FUSED_PACK
#define H2R_SCAN_FUSED_PACK 0
#endif
#ifndef H2R_SCAN_DEF
#define H2R_SCAN_DEF 0
#endif

#if H2R_SCAN_FUSED_PACK
#define H2R_KIN 8  // quad words m = 0..7 per position
#else
#define H2R_KIN H2R_KP
#endif

namespace {

constexpr int THREADS = 32;
// positions of the ring: 16 while the block's ring fits 32 KiB, fewer for
// wide inputs (one-hot class planes of many defs)
constexpr int RING_BYTES = H2R_KIN * THREADS * 4;  // one position
constexpr int RING = 16 * RING_BYTES <= 32768 ? 16
                     : 8 * RING_BYTES <= 32768 ? 8
                     : 4 * RING_BYTES <= 32768 ? 4
                                               : 2;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most RING - 2 groups are pending: the oldest of the RING - 1
// in flight has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int32_t* __restrict__ bits, int32_t* __restrict__ logs, int NW, int L) {
  __shared__ uint32_t ring[RING][H2R_KIN][THREADS];
  const int t = threadIdx.x;
  const int w = blockIdx.x * THREADS + t;
  if (w >= NW) return;
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  // position p's words into slot p % RING (an empty group past L)
  auto fetch = [&](int p) {
    if (p < L) {
#pragma unroll
      for (int k = 0; k < H2R_KIN; ++k)
        cp_async4(&ring[p % RING][k][t], bits + ((size_t)p * H2R_KIN + k) * NW + w);
    }
    cp_async_commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  uint32_t st[H2R_NLIVE];
  h2r_step_init(st);
  int32_t* lg_base = logs + (size_t)nws * H2R_SB_SUM * L * H2R_LANE + lane;
  H2R_PRAGMA_UNROLL(H2R_SCAN_UNROLL)
  for (int l = 0; l < L; ++l) {
    fetch(l + RING - 1);  // into slot (l - 1) % RING, read at l - 1
    cp_async_wait_oldest();
    uint32_t in[H2R_KIN];
#pragma unroll
    for (int k = 0; k < H2R_KIN; ++k) in[k] = ring[l % RING][k][t];
#if H2R_SCAN_FUSED_PACK
    uint32_t cls[8];  // the byte-bit planes (the step circuits fold the class BDD in)
    h2r_byte_planes(in, cls);
#else
    const uint32_t* cls = in;
#endif
    uint32_t lg[H2R_SB_SUM];
    h2r_step(cls, st, lg);
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j)
      lg_base[((size_t)j * L + l) * H2R_LANE] = (int32_t)lg[j];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

inline int launch(const void* bits, void* logs, int NW, int L, void* stream) {
  scan_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bits, (int32_t*)logs, NW, L);
  return (int)cudaGetLastError();
}

}  // namespace

#if H2R_SCAN_DEF
extern "C" int h2r_scan_def(const void* bits, void* logs, int NW, int L, void* stream) {
  return launch(bits, logs, NW, L, stream);
}
#elif H2R_SCAN_FUSED_PACK
extern "C" int h2r_scan_fpack(const void* quads, void* logs, int NW, int L, void* stream) {
  return launch(quads, logs, NW, L, stream);
}
#else
extern "C" int h2r_scan(const void* bits, void* logs, int NW, int L, void* stream) {
  return launch(bits, logs, NW, L, stream);
}
#endif
