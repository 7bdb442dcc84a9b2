// K3: post -- tags, id sum, mask FSMs, then one of two emissions:
//   bytes mode (columns="witness"): dummy splice, byte-group emission and
//     final-state boundary planes, entry h2r_post; with tiled input (the
//     generated header sets H2R_POST_TILED) it also reads the word group's
//     pretiled quad words, extracts their 8 byte-bit planes with the quad
//     mask and ANDs them with the mask FSM: the masked characters, emitted
//     as one more byte group, entry h2r_post_tiled;
//   planes mode (columns="full", the generated header sets
//     H2R_POST_PLANES): the named bit planes of the full RegexResult --
//     per def ids/start/endf, idsum, masked_idsum, fwd, bwd, mask -- entry
//     h2r_post_planes.
//
// Replaces the TPU kernel BitplaneMatcher._make_post in bytes mode with
// pre-dummied states, in its tiled mode (the masked characters from the
// quad words, :1455-1470, the extra input at :1547-1554), and in planes
// mode (halo2_regex_tpu/ops/bitplane.py :1338, pallas_call at :1592).
//
// What bounds it on the H100: latency, like the scan.  One thread owns one
// word and walks L twice; at B = 32768 that is 1024 threads on 32 SMs.
// Per position it runs the generated tag circuit of every def (91 ops for
// the from: model) plus the FSM steps and, in bytes mode, an 8x8 bit
// transpose per byte group.  Memory traffic is small by comparison: SB_SUM
// + 1 planes read twice, one fwd plane written and read back, and
// 8 * NGROUPS words (bytes mode) or P_total planes (planes mode) written;
// the tiled mode reads 8 more planes (the quad words) and writes 8 more
// words, and holds the 8 quad words and the 8 masked byte-bit planes of a
// position in registers on top of bytes mode's.
//
// Design: the two mask FSMs run as serial recurrences
// x = (x & hold[l]) | set[l], which is exactly what the TPU kernel's
// Hillis-Steele log-scan (_fsm_log_scan, :341) computes.
//   pass 1, l = 0 .. L-1: tag(l), id sum, forward FSM; fwd[l] goes to a
//     scratch plane the wrapper allocates (planes mode: to the output's
//     fwd plane), and planes mode also writes the per-def tag planes and
//     idsum here.
//   pass 2, l = L-1 .. 0: tag(l) again (recomputing is cheaper than
//     storing NSUM + 2 planes), backward FSM with ids_sum[l + 1] and
//     start_any[l + 1] carried in registers from the previous step, then
//     mask = fwd & bwd.  Bytes mode: the flags/masked-id/state fields, the
//     transpose and the byte-group stores, and the boundary planes
//     accumulate.  Planes mode: bwd, mask and masked_idsum stores.
// The prev planes of position 0 are the first state's bits.  Only the FSM
// bits x and y carry from one position to the next; the tag circuit and
// the emission of neighbouring positions are independent, so both loops
// are unrolled 4 times and one warp interleaves them (on the H100 for the
// from: model this halved the kernel; 8 was no better, 16 worse).  Each
// pass also loads the next position's planes while the current one
// computes.  Loads and stores are coalesced over words.
//
// Layouts: logs [NWS, SB_SUM, L, 128]; en and fwd [NWS, L, 128];
// bytes mode g4 [NWS, 8 * NGROUPS, L, 128] and fb [NWS, NDEFS, 8, 128];
// tiled mode also tiled [NWS, 8, L, 128]; planes mode out [NWS, P_TOTAL,
// L, 128]; all int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

#ifndef H2R_POST_PLANES
#define H2R_POST_PLANES 0
#endif
#ifndef H2R_POST_TILED
#define H2R_POST_TILED 0
#endif

namespace {

constexpr int THREADS = 32;

// fwd_buf: bytes mode the [NWS, L, 128] scratch plane (out is g4); planes
// mode unused (fwd lives in out).  tiled: the quad words (tiled mode only).
__global__ void __launch_bounds__(THREADS)
post_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ en,
            const int32_t* __restrict__ tiled, int32_t* __restrict__ fwd_buf,
            int32_t* __restrict__ out, int32_t* __restrict__ fb, int NW, int L) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= NW) return;
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  const size_t plane = (size_t)L * H2R_LANE;  // stride between planes
  const int32_t* lg_base = logs + (size_t)nws * H2R_SB_SUM * plane + lane;
  const int32_t* en_base = en + (size_t)nws * plane + lane;
#if H2R_POST_PLANES
  int32_t* out_base = out + (size_t)nws * H2R_P_TOTAL * plane + lane;
  int32_t* fwd_base = out_base + H2R_OFF_FWD * plane;
#else
  int32_t* fwd_base = fwd_buf + (size_t)nws * plane + lane;
  int32_t* g4_base = out + (size_t)nws * 8 * H2R_NGROUPS * plane + lane;
#endif
#if H2R_POST_TILED
  const int32_t* t_base = tiled + (size_t)nws * 8 * plane + lane;
#endif

  uint32_t first[H2R_SB_SUM];
  h2r_first_log(first);
  auto LOG = [&](int j, int l) { return (uint32_t)lg_base[j * plane + (size_t)l * H2R_LANE]; };
  auto EN = [&](int l) { return (uint32_t)en_base[(size_t)l * H2R_LANE]; };

  // pass 1: forward FSM.  The planes of position l + 1 are loaded while
  // position l computes (one warp per SM cannot hide load latency).
  {
    uint32_t prev[H2R_SB_SUM], cur[H2R_SB_SUM], prev_sum[H2R_NSUM];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) {
      prev[j] = first[j];
      cur[j] = LOG(j, 0);
    }
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) prev_sum[k] = 0;
    uint32_t e = EN(0), prev_endf = 0, x = 0;
#pragma unroll 4
    for (int l = 0; l < L; ++l) {
      const int ln = l + 1 < L ? l + 1 : l;
      uint32_t nxt[H2R_SB_SUM];
#pragma unroll
      for (int j = 0; j < H2R_SB_SUM; ++j) nxt[j] = LOG(j, ln);
      const uint32_t e_next = EN(ln);
      uint32_t ids[H2R_NSUM], sa, ea, dt[H2R_NDT];
      h2r_tag(prev, cur, e, ids, sa, ea, dt);
#if H2R_POST_PLANES
#pragma unroll
      for (int k = 0; k < H2R_NDT; ++k) out_base[k * plane + (size_t)l * H2R_LANE] = (int32_t)dt[k];
#pragma unroll
      for (int k = 0; k < H2R_NSUM; ++k)
        out_base[(H2R_OFF_IDSUM + k) * plane + (size_t)l * H2R_LANE] = (int32_t)ids[k];
#endif
      uint32_t changed = 0;
#pragma unroll
      for (int k = 0; k < H2R_NSUM; ++k) changed |= ids[k] ^ prev_sum[k];
      const uint32_t is_set = sa & changed;
      const uint32_t is_reset = ~sa & prev_endf & changed;
      x = (x & ~(is_set | is_reset)) | is_set;
      fwd_base[(size_t)l * H2R_LANE] = (int32_t)x;
#pragma unroll
      for (int k = 0; k < H2R_NSUM; ++k) prev_sum[k] = ids[k];
#pragma unroll
      for (int j = 0; j < H2R_SB_SUM; ++j) {
        prev[j] = cur[j];
        cur[j] = nxt[j];
      }
      prev_endf = ea;
      e = e_next;
    }
  }

  // pass 2: backward FSM and the rest of the emission; the planes of
  // position l - 1 (and the prev planes of l - 1, at l - 2) are loaded
  // while position l computes.
  uint32_t next_sum[H2R_NSUM], cur[H2R_SB_SUM], prv[H2R_SB_SUM];
#if !H2R_POST_PLANES
  uint32_t acc[H2R_SB_SUM];
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] = 0;
#endif
#pragma unroll
  for (int k = 0; k < H2R_NSUM; ++k) next_sum[k] = 0;
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) {
    cur[j] = LOG(j, L - 1);
    prv[j] = L > 1 ? LOG(j, L - 2) : first[j];
  }
  uint32_t e = EN(L - 1), fwd = (uint32_t)fwd_base[(size_t)(L - 1) * H2R_LANE];
  uint32_t next_start = 0, y = 0, en_next = 0;
#pragma unroll 4
  for (int l = L - 1; l >= 0; --l) {
    const int lp = l > 0 ? l - 1 : 0;
    uint32_t pp[H2R_SB_SUM];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) pp[j] = l > 1 ? LOG(j, l - 2) : first[j];
    const uint32_t e_prev = EN(lp);
    const uint32_t fwd_prev = (uint32_t)fwd_base[(size_t)lp * H2R_LANE];
    uint32_t ids[H2R_NSUM], sa, ea, dt[H2R_NDT];
    h2r_tag(prv, cur, e, ids, sa, ea, dt);
    uint32_t changed = 0;
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) changed |= ids[k] ^ next_sum[k];
    const uint32_t set_b = ea & changed;
    const uint32_t reset_b = ~ea & next_start & changed;
    y = (y & ~(set_b | reset_b)) | set_b;
    const uint32_t mask = fwd & y;
    uint32_t midsum[H2R_NSUM];
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) midsum[k] = ids[k] & mask;
#if H2R_POST_PLANES
    const size_t row = (size_t)l * H2R_LANE;
    out_base[H2R_OFF_BWD * plane + row] = (int32_t)y;
    out_base[H2R_OFF_MASK * plane + row] = (int32_t)mask;
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k)
      out_base[(H2R_OFF_MASKED_IDSUM + k) * plane + row] = (int32_t)midsum[k];
#else
    const uint32_t flags[6] = {mask, fwd, y, e, sa, ea};
    uint32_t mcp[8];  // masked byte-bit planes (tiled mode)
#if H2R_POST_TILED
    {
      uint32_t q[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) q[m] = (uint32_t)t_base[m * plane + (size_t)l * H2R_LANE];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t acc = 0;
#pragma unroll
        for (int m = 0; m < 8; ++m) acc |= ((q[m] >> j) & 0x01010101u) << m;
        mcp[j] = acc & mask;
      }
    }
#endif
    uint32_t words[8 * H2R_NGROUPS];
    h2r_emit(flags, midsum, cur, e, mcp, words);
#pragma unroll
    for (int k = 0; k < 8 * H2R_NGROUPS; ++k)
      g4_base[k * plane + (size_t)l * H2R_LANE] = (int32_t)words[k];
    const uint32_t bnd = e & ~en_next;
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] |= bnd & cur[j];
#endif
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) next_sum[k] = ids[k];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) {
      cur[j] = prv[j];
      prv[j] = pp[j];
    }
    next_start = sa;
    en_next = e;
    e = e_prev;
    fwd = fwd_prev;
  }
#if !H2R_POST_PLANES
  // strings whose first byte is disabled are empty
  uint32_t fbw[H2R_NDEFS * 8];
  h2r_fb(acc, ~EN(0), fbw);
#pragma unroll
  for (int k = 0; k < H2R_NDEFS * 8; ++k)
    fb[((size_t)nws * H2R_NDEFS * 8 + k) * H2R_LANE + lane] = (int32_t)fbw[k];
#endif
}

}  // namespace

#if H2R_POST_PLANES
extern "C" int h2r_post_planes(const void* logs, const void* en, void* out, int NW, int L,
                               void* stream) {
  post_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, nullptr, nullptr, (int32_t*)out, nullptr, NW,
      L);
  return (int)cudaGetLastError();
}
#elif H2R_POST_TILED
extern "C" int h2r_post_tiled(const void* logs, const void* en, const void* tiled,
                              void* fwd_buf, void* g4, void* fb, int NW, int L, void* stream) {
  post_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, (const int32_t*)tiled, (int32_t*)fwd_buf,
      (int32_t*)g4, (int32_t*)fb, NW, L);
  return (int)cudaGetLastError();
}
#else
extern "C" int h2r_post(const void* logs, const void* en, void* fwd_buf, void* g4, void* fb,
                        int NW, int L, void* stream) {
  post_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, nullptr, (int32_t*)fwd_buf, (int32_t*)g4,
      (int32_t*)fb, NW, L);
  return (int)cudaGetLastError();
}
#endif
