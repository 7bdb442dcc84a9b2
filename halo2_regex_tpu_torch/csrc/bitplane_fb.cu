// fb_only -- final-state boundary planes for match-only serving.
//
// Replaces the TPU kernel BitplaneMatcher._make_fb_only
// (halo2_regex_tpu/ops/bitplane.py:1606, pallas_call at :1635).
//
// Computes, per word and def, fb[d, j] = OR over positions l of
// (bnd[l] & log[d, j][l]), with bnd[l] = en[l] & ~en[l + 1] (en[L] = 0),
// i.e. the log bits of each string's state after its last enabled byte,
// ORed with the first state's bits for empty strings (~en[0]).  bnd needs
// only the neighbouring row, so nothing is serial: it is a pure OR
// reduction over positions.
//
// What bounds it on the H100: device-memory bytes.  The TPU kernel reads
// all SB_SUM + 1 planes (about 24 MiB for the from: model at B=32768 x
// L=1024).  Here a thread loads a log word only where its bnd word is
// nonzero; each string has one boundary row, so a word's 32 strings touch
// at most 32 of its L rows and the log reads shrink to a few percent of
// the planes, leaving the enable plane (4 MiB at that size) as the bulk.
//
// Design: the work is split over positions as well as words, not one
// thread per word walking L as in K2/K3 (1024 threads on 32 SMs at bench
// size).  A block is 128 lanes (one row of words, coalesced loads) x ROWS
// position groups of PER consecutive positions; grid.x runs over NWS x
// position chunks of ROWS * PER, so B=32768 x L=1024 gives 256 blocks of
// 512 threads.  Each thread keeps its partial OR of every log plane in
// registers, then ORs the nonzero ones into the zeroed output with
// atomicOr (order-free, so the result is deterministic).  The thread of
// position 0 adds the empty-string term through the generated h2r_fb,
// which also maps log planes to the [NDEFS, 8] slots.
//
// Layouts: logs [NWS, SB_SUM, L, 128]; en [NWS, L, 128]; fb [NWS, NDEFS,
// 8, 128], zeroed by the wrapper; all int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int ROWS = 4;  // position groups per block (threadIdx.y)
constexpr int PER = 8;   // consecutive positions per thread
constexpr int CHUNK = ROWS * PER;

__global__ void __launch_bounds__(H2R_LANE * ROWS)
fb_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ en,
          int32_t* __restrict__ fb, int n_chunks, int L) {
  const int nws = blockIdx.x / n_chunks;
  const int lane = threadIdx.x;
  const int l_begin = (blockIdx.x % n_chunks) * CHUNK + threadIdx.y * PER;
  if (l_begin >= L) return;
  const int l_end = l_begin + PER < L ? l_begin + PER : L;
  const size_t plane = (size_t)L * H2R_LANE;
  const int32_t* lg_base = logs + (size_t)nws * H2R_SB_SUM * plane + lane;
  const int32_t* en_base = en + (size_t)nws * plane + lane;

  uint32_t acc[H2R_SB_SUM];
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] = 0;
  uint32_t e = (uint32_t)en_base[(size_t)l_begin * H2R_LANE];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int l = l_begin + p;
    if (l >= l_end) break;
    const uint32_t e_next = l + 1 < L ? (uint32_t)en_base[(size_t)(l + 1) * H2R_LANE] : 0u;
    const uint32_t bnd = e & ~e_next;
    if (bnd) {
#pragma unroll
      for (int j = 0; j < H2R_SB_SUM; ++j)
        acc[j] |= bnd & (uint32_t)lg_base[j * plane + (size_t)l * H2R_LANE];
    }
    e = e_next;
  }
  // strings whose first byte is disabled are empty: their final state is
  // the first state (added once, by the thread that owns position 0)
  const uint32_t empty = l_begin == 0 ? ~(uint32_t)en_base[0] : 0u;
  uint32_t out[H2R_NDEFS * 8];
  h2r_fb(acc, empty, out);
#pragma unroll
  for (int k = 0; k < H2R_NDEFS * 8; ++k)
    if (out[k])
      atomicOr(reinterpret_cast<unsigned int*>(fb) +
                   ((size_t)nws * H2R_NDEFS * 8 + k) * H2R_LANE + lane,
               out[k]);
}

}  // namespace

extern "C" int h2r_fb_only(const void* logs, const void* en, void* fb, int NWS, int L,
                           void* stream) {
  const int n_chunks = (L + CHUNK - 1) / CHUNK;
  dim3 block(H2R_LANE, ROWS);
  fb_kernel<<<NWS * n_chunks, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, (int32_t*)fb, n_chunks, L);
  return (int)cudaGetLastError();
}
