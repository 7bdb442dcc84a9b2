// K2: scan -- the serial DFA recurrence of every def.
//
// Replaces the TPU kernel BitplaneMatcher._make_scan_fused
// (halo2_regex_tpu/ops/bitplane.py:934, pallas_call at :1013).
//
// What bounds it on the H100: latency.  One thread owns one word (32
// strings) and walks all L positions in order; each position runs the
// generated step circuit of every def (240 dependent-chain ops for the
// zk-email from: model) on one-hot live-state planes held in registers.
// At B = 32768 there are only NW = 1024 threads, so the kernel runs 32
// warps on 32 of the 132 SMs and cannot hide the latency of the circuit's
// dependency chain.  That is the design's known limit, left for later.
//
// What the design does about it: blocks of 32 threads spread the warps
// over as many SMs as there are warps; the class planes of position l + 1
// are loaded while position l computes, so global-load latency overlaps
// the circuit; the position loop is unrolled 4 times so the warp can
// interleave neighbouring positions' loads, stores and loop work (on the
// H100 for the from: model, 4 beat 1, 2, 8 and 16); the one-hot states
// never leave registers, and one thread's loop covers all of L, so no
// carry passes between blocks (the TPU grid carried them through VMEM
// scratch between L-chunks).  Class-plane reads and log-plane writes are
// coalesced over words.
//
// Layouts: bits [L, KP, NWS, 128] int32; logs [NWS, SB_SUM, L, 128] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int32_t* __restrict__ bits, int32_t* __restrict__ logs, int NW, int L) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= NW) return;
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  uint32_t st[H2R_NLIVE];
  h2r_step_init(st);
  uint32_t cls[H2R_KP];
#pragma unroll
  for (int k = 0; k < H2R_KP; ++k) cls[k] = (uint32_t)bits[(size_t)k * NW + w];
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    uint32_t nxt[H2R_KP];
    const int ln = l + 1 < L ? l + 1 : l;
#pragma unroll
    for (int k = 0; k < H2R_KP; ++k)
      nxt[k] = (uint32_t)bits[((size_t)ln * H2R_KP + k) * NW + w];
    uint32_t lg[H2R_SB_SUM];
    h2r_step(cls, st, lg);
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j)
      logs[(((size_t)nws * H2R_SB_SUM + j) * L + l) * H2R_LANE + lane] = (int32_t)lg[j];
#pragma unroll
    for (int k = 0; k < H2R_KP; ++k) cls[k] = nxt[k];
  }
}

}  // namespace

extern "C" int h2r_scan(const void* bits, void* logs, int NW, int L, void* stream) {
  scan_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bits, (int32_t*)logs, NW, L);
  return (int)cudaGetLastError();
}
