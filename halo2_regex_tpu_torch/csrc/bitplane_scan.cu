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
// threads, so the kernel runs 32 warps on 32 of the 132 SMs and cannot
// hide the latency of the circuit's dependency chain.  That is the
// design's known limit, left for later.
//
// What the design does about it: blocks of 32 threads spread the warps
// over as many SMs as there are warps; the input planes of position l + 1
// are loaded while position l computes, so global-load latency overlaps
// the circuit; the position loop is unrolled H2R_SCAN_UNROLL times (the
// unroll knob; 4 by default: on the H100 for the from: model, 4 beat 1,
// 2, 8 and 16) so the warp can interleave neighbouring positions' loads,
// stores and loop work; the one-hot states never leave registers, and one
// thread's loop covers all of L, so no carry passes between blocks (the
// TPU grid carried them through VMEM scratch between L-chunks).  Reads and
// log-plane writes are coalesced over words.  scan_fpack needs no scratch
// for its planes (the TPU kernel staged a chunk's in VMEM): a word's 8
// byte-bit planes at a position depend only on its own 8 quad words m =
// 0..7, which the thread loads as it would load 8 class planes.
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

__global__ void __launch_bounds__(THREADS)
scan_kernel(const int32_t* __restrict__ bits, int32_t* __restrict__ logs, int NW, int L) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= NW) return;
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  uint32_t st[H2R_NLIVE];
  h2r_step_init(st);
  uint32_t in[H2R_KIN];
#pragma unroll
  for (int k = 0; k < H2R_KIN; ++k) in[k] = (uint32_t)bits[(size_t)k * NW + w];
  H2R_PRAGMA_UNROLL(H2R_SCAN_UNROLL)
  for (int l = 0; l < L; ++l) {
    uint32_t nxt[H2R_KIN];
    const int ln = l + 1 < L ? l + 1 : l;
#pragma unroll
    for (int k = 0; k < H2R_KIN; ++k)
      nxt[k] = (uint32_t)bits[((size_t)ln * H2R_KIN + k) * NW + w];
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
      logs[(((size_t)nws * H2R_SB_SUM + j) * L + l) * H2R_LANE + lane] = (int32_t)lg[j];
#pragma unroll
    for (int k = 0; k < H2R_KIN; ++k) in[k] = nxt[k];
  }
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
