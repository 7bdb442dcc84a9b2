// K3: post -- tags, id sum, mask FSMs, then one of three emissions:
//   bytes mode (columns="witness", emit bytes or kdecode): dummy splice,
//     byte-group emission and final-state boundary planes, entry h2r_post;
//     with tiled input (the generated header sets H2R_POST_TILED) it also
//     reads the word group's pretiled quad words, extracts their 8
//     byte-bit planes with the quad mask and ANDs them with the mask FSM:
//     the masked characters, emitted as one more byte group, entry
//     h2r_post_tiled;
//   direct mode (emit direct, the header sets H2R_POST_DIRECT): the dummy
//     splice and the 8x8 transpose of each field (one field per group),
//     written straight into string-major l4-packed arrays, no boundary
//     planes, entry h2r_post_direct;
//   planes mode (the header sets H2R_POST_PLANES): named bit planes --
//     for columns="full" per def ids/start/endf, idsum, masked_idsum, fwd,
//     bwd, mask; for the witness planes emission masked_idsum, fwd, bwd,
//     mask, start_any, endf_any -- entry h2r_post_planes.
//
// Replaces the TPU kernel BitplaneMatcher._make_post in bytes mode with
// pre-dummied states, in its tiled mode (the masked characters from the
// quad words, :1455-1470, the extra input at :1547-1554), in direct mode
// (:1471-1492, outputs :1555-1567) and in planes mode with the full and
// the witness plans (:671-704) (halo2_regex_tpu/ops/bitplane.py :1338,
// pallas_call at :1592).
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
// Direct mode: the JAX kernel built each field's string-major rows with
// in-VMEM tile transposes; here the thread that owns word w holds, for
// each field, transposed word m whose byte lane s belongs to row
// (m * NWS + nws) * 512 + 4 * lane + s, column l of the field's [B, L]
// bytes (byte l % 4 of int32 column l / 4).  The words of DP positions
// are staged in shared memory (dynamic, up to 200 KiB: one warp a block,
// at most one block an SM at B = 32768, so it costs no occupancy); at
// each chunk's first position the warp writes the chunk out, 32 bytes of
// a row per 8 threads after a 4 x 4 byte transpose.  Stored straight to
// global memory, one byte per row and position, a warp store would touch
// 32 rows L bytes apart.
//
// Layouts: logs [NWS, SB_SUM, L, 128]; en and fwd [NWS, L, 128];
// bytes mode g4 [NWS, 8 * NGROUPS, L, 128] and fb [NWS, NDEFS, 8, 128];
// tiled mode also tiled [NWS, 8, L, 128]; planes mode out [NWS, P_TOTAL,
// L, 128]; direct mode out [NGROUPS, 8, NWS, 512, L / 4] (the fields'
// [B, L] bytes); all int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

#ifndef H2R_POST_PLANES
#define H2R_POST_PLANES 0
#endif
#ifndef H2R_POST_TILED
#define H2R_POST_TILED 0
#endif
#ifndef H2R_POST_DIRECT
#define H2R_POST_DIRECT 0
#endif

namespace {

constexpr int THREADS = 32;

#if H2R_POST_DIRECT
// Direct mode stages the emission words of DP positions in shared memory
// (word k of position l % DP and thread t at (k * DP + l % DP) * DPITCH + t) and
// writes each chunk out row by row.  DP = 32 positions (32-byte row
// segments, full sectors) while the stage fits 200 KiB, else fewer.
constexpr int DWORDS = 8 * H2R_NGROUPS;  // emission words per position
constexpr int DPITCH = THREADS + 1;
constexpr int DSTAGE_UNIT = DWORDS * DPITCH * 4;  // bytes per staged position
constexpr int DP = 32 * DSTAGE_UNIT <= 200 * 1024   ? 32
                   : 16 * DSTAGE_UNIT <= 200 * 1024 ? 16
                   : 8 * DSTAGE_UNIT <= 200 * 1024  ? 8
                                                    : 4;
static_assert(DP * DSTAGE_UNIT <= 227 * 1024, "direct emission: too many fields to stage");
constexpr int DSTAGE_BYTES = DP * DSTAGE_UNIT;

#endif

// fwd_buf: bytes and direct modes the [NWS, L, 128] scratch plane (out is
// g4, or the direct arrays); planes mode unused (fwd lives in out).
// tiled: the quad words (tiled mode only).
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
#elif H2R_POST_DIRECT
  int32_t* fwd_base = fwd_buf + (size_t)nws * plane + lane;
  extern __shared__ uint32_t stage[];
  const int t = threadIdx.x;
  // the block's first row for m = 0 in field 0's [B, L] bytes: thread t's
  // rows are 4 t + s after it
  uint8_t* d_base = reinterpret_cast<uint8_t*>(out) + ((size_t)nws * 512 + 4 * (lane - t)) * L;
  const size_t d_m = (size_t)NW / H2R_LANE * 512 * L;  // next m: NWS * 512 rows
  const size_t d_field = 8 * d_m;                      // next field: B rows
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
#ifdef H2R_OFF_IDSUM  // full: the per-def planes first, then idsum
#pragma unroll
      for (int k = 0; k < H2R_NDT; ++k) out_base[k * plane + (size_t)l * H2R_LANE] = (int32_t)dt[k];
#pragma unroll
      for (int k = 0; k < H2R_NSUM; ++k)
        out_base[(H2R_OFF_IDSUM + k) * plane + (size_t)l * H2R_LANE] = (int32_t)ids[k];
#endif
#ifdef H2R_OFF_START_ANY  // the witness planes emission
      out_base[H2R_OFF_START_ANY * plane + (size_t)l * H2R_LANE] = (int32_t)sa;
      out_base[H2R_OFF_ENDF_ANY * plane + (size_t)l * H2R_LANE] = (int32_t)ea;
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
#if !H2R_POST_PLANES && !H2R_POST_DIRECT
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
      h2r_byte_planes(q, mcp);
#pragma unroll
      for (int j = 0; j < 8; ++j) mcp[j] &= mask;
    }
#endif
    uint32_t words[8 * H2R_NGROUPS];
    h2r_emit(flags, midsum, cur, e, mcp, words);
#if H2R_POST_DIRECT
    // word k = 8 * field + m: byte lane s is string 4 * (w + NW * m) + s,
    // row 4 t + s of the block's rows; staged, and at a chunk's first
    // position the chunk [l, l + n) goes out: item (k, t2, g) is the 4 x 4
    // bytes of rows 4 t2 + s at columns l + 4 g .. + 3, so 8 threads write
    // a row's 32 bytes and a warp store 4 rows
    const int dpos = l % DP;
#pragma unroll
    for (int k = 0; k < DWORDS; ++k) stage[(k * DP + dpos) * DPITCH + t] = words[k];
    if (dpos == 0) {
      __syncwarp();
      const int g = t % 8, n4 = min(DP, L - l) / 4;
      if (g < n4) {
        for (int k = 0; k < DWORDS; ++k) {
          uint8_t* p = d_base + (k >> 3) * d_field + (k & 7) * d_m + l + 4 * g;
#pragma unroll
          for (int i = 0; i < THREADS / 4; ++i) {
            const int t2 = 4 * i + t / 8;
            uint32_t v[4], o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = stage[(k * DP + 4 * g + j) * DPITCH + t2];
            h2r_bytes4x4(v, o);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              *reinterpret_cast<uint32_t*>(p + (size_t)(4 * t2 + s) * L) = o[s];
          }
        }
      }
      __syncwarp();
    }
#else
#pragma unroll
    for (int k = 0; k < 8 * H2R_NGROUPS; ++k)
      g4_base[k * plane + (size_t)l * H2R_LANE] = (int32_t)words[k];
    const uint32_t bnd = e & ~en_next;
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] |= bnd & cur[j];
#endif
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
#if !H2R_POST_PLANES && !H2R_POST_DIRECT
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
#elif H2R_POST_DIRECT
extern "C" int h2r_post_direct(const void* logs, const void* en, void* fwd_buf, void* out,
                               int NW, int L, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DSTAGE_BYTES);
  if (err != cudaSuccess) return (int)err;
  post_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, DSTAGE_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, nullptr, (int32_t*)fwd_buf, (int32_t*)out,
      nullptr, NW, L);
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
