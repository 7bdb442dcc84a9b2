// K3: post -- tags, id sum, mask FSMs, then one of four emissions:
//   bytes mode (columns="witness", emit bytes or kdecode): dummy splice,
//     byte-group emission and final-state boundary planes, entry h2r_post;
//     with tiled input (the generated header sets H2R_POST_TILED) it also
//     reads the word group's pretiled quad words, extracts their 8
//     byte-bit planes with the quad mask and ANDs them with the mask FSM:
//     the masked characters, emitted as one more byte group, entry
//     h2r_post_tiled;
//   planes mode (the header sets H2R_POST_PLANES): named bit planes --
//     for columns="full" per def ids/start/endf, idsum, masked_idsum, fwd,
//     bwd, mask; for the witness planes emission masked_idsum, fwd, bwd,
//     mask, start_any, endf_any -- entry h2r_post_planes;
//   direct mode (emit direct, the header sets H2R_POST_DIRECT): the dummy
//     splice and the 8x8 transpose of each field (one field per group),
//     written straight into string-major l4-packed arrays, no boundary
//     planes, entry h2r_post_direct.
//
// Replaces the TPU kernel BitplaneMatcher._make_post in bytes mode with
// pre-dummied states, in its tiled mode (the masked characters from the
// quad words, :1455-1470, the extra input at :1547-1554), in planes mode
// with the full and the witness plans (:671-704) and in direct mode
// (:1471-1492, outputs :1555-1567) (halo2_regex_tpu/ops/bitplane.py :1338,
// pallas_call at :1592).
//
// What bounds it on the H100: latency and occupancy, not bytes.  Per
// position and word the generated tag circuit of every def runs (91 ops
// for the from: model), the FSM steps and an 8x8 bit transpose per byte
// group or field; the memory traffic (SB_SUM + 1 planes read, 8 * NGROUPS
// words or P_TOTAL planes or the fields' [B, L] bytes written) takes a
// few percent of the time.  The only serial dependence along L is the two
// 1-bit mask FSMs, x' = (x & hold[l]) | set[l], forward and backward.
// Walked serially by one thread per word (the earlier design), the kernel
// ran on 1024 threads at B = 32768: one warp on each of 32 SMs, its
// latency exposed (0.61 ms in bytes mode on an H100, 0.97 ms in direct
// mode, against 0.08 ms for the chunked design below in bytes mode).
//
// Design, every mode: the FSM maps compose associatively (the JAX
// kernel's log-scan, _fsm_log_scan :341), so L is cut into chunks of CL
// positions (CL <= CL_MAX, set by the wrapper) and each (word, chunk) gets
// a thread; a warp covers 32 consecutive words at one chunk, so loads and
// stores stay coalesced over words, and at B = 32768, CL = 32 the kernel
// runs 32768 threads instead of 1024.  Three launches, as blocks run in
// no order:
//   A, h2r_post_maps: each chunk recomputes the tags of positions c0 - 1
//     .. c1 (it needs the ids and flags on both sides of its edge) and
//     composes its forward map (hold, set) and its backward map, written
//     to a [4, NCH, NW] scratch;
//   B, h2r_post_carry: one thread per word composes the chunk maps in
//     order (forward) and in reverse (backward) and overwrites each
//     chunk's hold words with its carry-in x and y;
//   C, h2r_post / h2r_post_tiled / h2r_post_planes / h2r_post_direct:
//     each chunk replays its positions from its carry-in x, keeping x of
//     each position in shared memory (CL_MAX words a thread), then walks
//     them again from the top with y, computes mask = x & y and emits:
//     byte groups through h2r_emit and the 8x8 transposes, or the named
//     planes, or the fields' rows.  The boundary planes, an OR over
//     positions, are ORed across chunks with atomicOr into an fb the
//     wrapper zeroes.
// The tags are computed three times a position (A, and both walks of C),
// against two in the serial design: ops are cheap here, occupancy is not.
//
// Direct mode's launch C: a block is one warp (32 words at one chunk).
// The JAX kernel built each field's string-major rows with in-VMEM tile
// transposes; here word w's field planes 8x8-transposed give 8 words m
// whose byte lane s belongs to row (m * NWS + nws) * 512 + 4 * lane + s,
// column l of the field's [B, L] bytes (byte l % 4 of int32 column l / 4).
// A warp stages its 32 lanes' field planes (H2R_DPLANES a position: 12
// for the from: model's flags, masked id sum and states) for DP positions
// in dynamic shared memory; at the lowest position of each group the warp
// transposes and writes the group out (direct_write): DP bytes of a row
// per DP / 4 threads.  The row segment matters more than the warps an
// SM: a 32-byte one is a whole sector of the L2, and on an H100 a
// 16-byte one made the kernel 2.8x slower and an 8-byte one 5.9x, though
// they fit 2x and 3.5x the warps (an earlier form that staged the
// transposed words, 8 a field).  So DP = 32 while the stage fits 200 KiB:
// for the from: model 49.5 KiB, four warps an SM (as words: 99 KiB, two).  Direct mode needs CL
// and L to be multiples of 4 (a 4-position column is one int32 of a row).
//
// Layouts: logs [NWS, SB_SUM, L, 128]; en [NWS, L, 128]; bytes mode g4
// [NWS, 8 * NGROUPS, L, 128] and fb [NWS, NDEFS, 8, 128]; tiled mode also
// tiled [NWS, 8, L, 128]; planes mode out [NWS, P_TOTAL, L, 128]; direct
// mode out [NGROUPS, 8, NWS, 512, L / 4] (the fields' [B, L] bytes); the
// chunk scratch [4, NCH, NW]; all int32.

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

constexpr int THREADS = 256;  // words of a block of A and B, all at one chunk
constexpr int CL_MAX = 32;    // positions of a chunk at most (x kept in shared memory)

#if H2R_POST_DIRECT
constexpr int C_THREADS = 32;  // launch C: one warp a block, with its own stage
// The stage: plane k of the position at slot i of its group and thread t
// at (k * DP + i) * DPITCH + t (the pitch keeps the writer's column reads
// free of bank conflicts).
constexpr int kDirectStage = 200 * 1024;  // bytes of stage a warp at most
constexpr int DPITCH = C_THREADS + 1;
constexpr int DSTAGE_UNIT = H2R_DPLANES * DPITCH * 4;  // bytes per staged position
constexpr int DP = 32 * DSTAGE_UNIT <= kDirectStage   ? 32
                   : 16 * DSTAGE_UNIT <= kDirectStage ? 16
                   : 8 * DSTAGE_UNIT <= kDirectStage  ? 8
                                                      : 4;
static_assert(DP * DSTAGE_UNIT <= 220 * 1024, "direct emission: too many fields to stage");
constexpr int DSTAGE_BYTES = DP * DSTAGE_UNIT;
#else
constexpr int C_THREADS = THREADS;
#endif

// One (word, chunk) thread's view of the planes: word w's column of the
// log planes and the enable plane.
struct Column {
  const int32_t* lg;
  const int32_t* en;
  size_t plane;
  __device__ void logs(int l, uint32_t* out) const {
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) out[j] = (uint32_t)lg[j * plane + (size_t)l * H2R_LANE];
  }
  __device__ uint32_t enable(int l) const { return (uint32_t)en[(size_t)l * H2R_LANE]; }
};

__device__ __forceinline__ Column column(const int32_t* logs, const int32_t* en, int w, int L) {
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  const size_t plane = (size_t)L * H2R_LANE;
  return {logs + (size_t)nws * H2R_SB_SUM * plane + lane, en + (size_t)nws * plane + lane, plane};
}

__device__ __forceinline__ uint32_t ids_changed(const uint32_t* a, const uint32_t* b) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < H2R_NSUM; ++k) c |= a[k] ^ b[k];
  return c;
}

// The ids and end flags of position c0 - 1 (zeros at c0 = 0) and the log
// planes there (the first state's at c0 = 0): where a chunk's ascending
// walk starts.
__device__ __forceinline__ void enter_chunk(const Column& col, int c0, uint32_t* prv,
                                            uint32_t* prev_sum, uint32_t& prev_endf) {
  h2r_first_log(prv);
#pragma unroll
  for (int k = 0; k < H2R_NSUM; ++k) prev_sum[k] = 0;
  prev_endf = 0;
  if (c0 > 0) {
    uint32_t pp[H2R_SB_SUM], sa, dt[H2R_NDT];
    if (c0 > 1) col.logs(c0 - 2, pp);
    else h2r_first_log(pp);
    col.logs(c0 - 1, prv);
    h2r_tag(pp, prv, col.enable(c0 - 1), prev_sum, sa, prev_endf, dt);
  }
}

// A: each chunk's forward and backward maps (hold, set), composed over its
// positions, into scr [4, NCH, NW]: rows forward hold, forward set,
// backward hold, backward set.
__global__ void __launch_bounds__(THREADS)
post_maps_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ en,
                 int32_t* __restrict__ scr, int NW, int L, int CL) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= NW) return;
  const int c = blockIdx.y, NCH = gridDim.y;
  const int c0 = c * CL, c1 = min(c0 + CL, L);
  const Column col = column(logs, en, w, L);
  uint32_t prv[H2R_SB_SUM], prev_sum[H2R_NSUM], prev_endf;
  enter_chunk(col, c0, prv, prev_sum, prev_endf);
  uint32_t fh = ~0u, fs = 0, bh = ~0u, bs = 0;
#pragma unroll 4
  for (int l = c0; l < c1; ++l) {
    uint32_t cur[H2R_SB_SUM], ids[H2R_NSUM], sa, ea, dt[H2R_NDT];
    col.logs(l, cur);
    h2r_tag(prv, cur, col.enable(l), ids, sa, ea, dt);
    const uint32_t changed = ids_changed(ids, prev_sum);
    const uint32_t set = sa & changed, reset = ~sa & prev_endf & changed;
    fs = (fs & ~(set | reset)) | set;  // f_l after the maps before it
    fh &= ~(set | reset);
    if (l > c0) {  // position l - 1's backward step, whose next is l
      const uint32_t set_b = prev_endf & changed, reset_b = ~prev_endf & sa & changed;
      bs |= set_b & bh;  // the maps above it after f_{l-1}
      bh &= ~(set_b | reset_b);
    }
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) prev_sum[k] = ids[k];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) prv[j] = cur[j];
    prev_endf = ea;
  }
  // position c1 - 1's backward step: its next is c1 (nothing past L)
  uint32_t next_sum[H2R_NSUM], next_start = 0;
#pragma unroll
  for (int k = 0; k < H2R_NSUM; ++k) next_sum[k] = 0;
  if (c1 < L) {
    uint32_t cur[H2R_SB_SUM], ea, dt[H2R_NDT];
    col.logs(c1, cur);
    h2r_tag(prv, cur, col.enable(c1), next_sum, next_start, ea, dt);
  }
  const uint32_t changed = ids_changed(prev_sum, next_sum);
  const uint32_t set_b = prev_endf & changed, reset_b = ~prev_endf & next_start & changed;
  bs |= set_b & bh;
  bh &= ~(set_b | reset_b);
  const size_t row = (size_t)NCH * NW;
  int32_t* m = scr + (size_t)c * NW + w;
  m[0] = (int32_t)fh;
  m[row] = (int32_t)fs;
  m[2 * row] = (int32_t)bh;
  m[3 * row] = (int32_t)bs;
}

// B: per word, the carry-in of each chunk: x entering it from below (the
// forward maps of the chunks before it, applied to 0) into row 0, y
// entering it from above (the backward maps of the chunks after it) into
// row 2.
__global__ void __launch_bounds__(THREADS)
post_carry_kernel(int32_t* __restrict__ scr, int NW, int NCH) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= NW) return;
  const size_t row = (size_t)NCH * NW;
  int32_t* m = scr + w;
  uint32_t x = 0, y = 0;
#pragma unroll 8
  for (int c = 0; c < NCH; ++c) {
    const uint32_t h = (uint32_t)m[(size_t)c * NW], s = (uint32_t)m[row + (size_t)c * NW];
    m[(size_t)c * NW] = (int32_t)x;
    x = (x & h) | s;
  }
#pragma unroll 8
  for (int c = NCH - 1; c >= 0; --c) {
    const uint32_t h = (uint32_t)m[2 * row + (size_t)c * NW];
    const uint32_t s = (uint32_t)m[3 * row + (size_t)c * NW];
    m[2 * row + (size_t)c * NW] = (int32_t)y;
    y = (y & h) | s;
  }
}

#if H2R_POST_DIRECT
// Direct mode's writer: the staged group [l, l + 4 n4) of a warp (32
// words at one chunk) out to the fields' [B, L] bytes.  Item (f, t2, g):
// field f's planes of word t2 at the 4 positions l + 4 g .. + 3, each
// position's planes 8x8-transposed into 8 words (word m: byte lane s is
// string 4 * (w + NW * m) + s), each word's 4 positions 4 x 4
// byte-transposed into rows 4 t2 + s of columns l + 4 g .. + 3.  A
// thread takes g = t % 8 and t2 = 4 i + t / 8, so n4 threads write a
// row's 4 n4 bytes and a warp store 4 rows.
__device__ __forceinline__ void direct_write(const uint32_t* stage, uint8_t* d_base, size_t d_m,
                                             size_t d_field, int L, int l, int n4, int t) {
  const int g = t % 8;
  if (g >= n4) return;
#pragma unroll
  for (int f = 0; f < H2R_DFIELDS; ++f) {
    int off, nb;
    h2r_direct_field(f, off, nb);
    uint8_t* p = d_base + f * d_field + l + 4 * g;
    for (int i = 0; i < C_THREADS / 4; ++i) {
      const int t2 = 4 * i + t / 8;
      uint32_t v[8][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t q[8];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          q[b] = b < nb ? stage[((off + b) * DP + 4 * g + j) * DPITCH + t2] : 0u;
        h2r_transpose8(q);
#pragma unroll
        for (int m = 0; m < 8; ++m) v[m][j] = q[m];
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        uint32_t o[4];
        h2r_bytes4x4(v[m], o);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          *reinterpret_cast<uint32_t*>(p + m * d_m + (size_t)(4 * t2 + s) * L) = o[s];
      }
    }
  }
}
#endif

// C: each chunk's replay from its carry-ins and the emission.
// tiled: the quad words (tiled mode only); fb: zeroed by the caller
// (bytes and tiled modes); out: g4, the planes or the fields' bytes.
__global__ void __launch_bounds__(C_THREADS)
post_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ en,
            const int32_t* __restrict__ tiled, const int32_t* __restrict__ scr,
            int32_t* __restrict__ out, int32_t* __restrict__ fb, int NW, int L, int CL) {
  __shared__ uint32_t xs[CL_MAX * C_THREADS];  // x of each position of the chunk
  const int t = threadIdx.x;
  const int w = blockIdx.x * C_THREADS + t;
  if (w >= NW) return;
  const int c = blockIdx.y, NCH = gridDim.y;
  const int c0 = c * CL, c1 = min(c0 + CL, L);
  const int nws = w / H2R_LANE, lane = w % H2R_LANE;
  const Column col = column(logs, en, w, L);
  const size_t plane = col.plane;
#if H2R_POST_PLANES
  int32_t* out_base = out + (size_t)nws * H2R_P_TOTAL * plane + lane;
#elif H2R_POST_DIRECT
  extern __shared__ uint32_t stage[];
  // the block's first row for m = 0 in field 0's [B, L] bytes: thread t's
  // rows are 4 t + s after it (NW is a multiple of 128, so a warp's words
  // share one nws)
  uint8_t* d_base = reinterpret_cast<uint8_t*>(out) + ((size_t)nws * 512 + 4 * (lane - t)) * L;
  const size_t d_m = (size_t)NW / H2R_LANE * 512 * L;  // next m: NWS * 512 rows
  const size_t d_field = 8 * d_m;                      // next field: B rows
#else
  int32_t* g4_base = out + (size_t)nws * 8 * H2R_NGROUPS * plane + lane;
#endif
#if H2R_POST_TILED
  const int32_t* t_base = tiled + (size_t)nws * 8 * plane + lane;
#endif
  uint32_t x = (uint32_t)scr[(size_t)c * NW + w];
  uint32_t y = (uint32_t)scr[(2 * (size_t)NCH + c) * NW + w];

  // ascending: the forward FSM from x, each position's x into xs (planes
  // mode: also the per-def tags, the id sum, the flags and fwd)
  uint32_t prv[H2R_SB_SUM], prev_sum[H2R_NSUM], prev_endf;
  enter_chunk(col, c0, prv, prev_sum, prev_endf);
#pragma unroll 4
  for (int l = c0; l < c1; ++l) {
    uint32_t cur[H2R_SB_SUM], ids[H2R_NSUM], sa, ea, dt[H2R_NDT];
    col.logs(l, cur);
    h2r_tag(prv, cur, col.enable(l), ids, sa, ea, dt);
    const uint32_t changed = ids_changed(ids, prev_sum);
    const uint32_t set = sa & changed, reset = ~sa & prev_endf & changed;
    x = (x & ~(set | reset)) | set;
    xs[(l - c0) * C_THREADS + t] = x;
#if H2R_POST_PLANES
    const size_t row = (size_t)l * H2R_LANE;
    out_base[H2R_OFF_FWD * plane + row] = (int32_t)x;
#ifdef H2R_OFF_IDSUM  // full: the per-def planes first, then idsum
#pragma unroll
    for (int k = 0; k < H2R_NDT; ++k) out_base[k * plane + row] = (int32_t)dt[k];
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k)
      out_base[(H2R_OFF_IDSUM + k) * plane + row] = (int32_t)ids[k];
#endif
#ifdef H2R_OFF_START_ANY  // the witness planes emission
    out_base[H2R_OFF_START_ANY * plane + row] = (int32_t)sa;
    out_base[H2R_OFF_ENDF_ANY * plane + row] = (int32_t)ea;
#endif
#endif
#pragma unroll
    for (int k = 0; k < H2R_NSUM; ++k) prev_sum[k] = ids[k];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) prv[j] = cur[j];
    prev_endf = ea;
  }

  // descending: the backward FSM from y, mask = x & y, the emission.  At
  // the top the ids and start flags of c1 (zeros past L); prv holds the
  // log planes of c1 - 1.
  uint32_t next_sum[H2R_NSUM], next_start = 0, en_next = 0, cur[H2R_SB_SUM];
#pragma unroll
  for (int k = 0; k < H2R_NSUM; ++k) next_sum[k] = 0;
  if (c1 < L) {
    uint32_t nx[H2R_SB_SUM], ea, dt[H2R_NDT];
    col.logs(c1, nx);
    en_next = col.enable(c1);
    h2r_tag(prv, nx, en_next, next_sum, next_start, ea, dt);
  }
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) cur[j] = prv[j];
#if !H2R_POST_PLANES && !H2R_POST_DIRECT
  uint32_t acc[H2R_SB_SUM];
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] = 0;
#endif
#pragma unroll 2
  for (int l = c1 - 1; l >= c0; --l) {
    uint32_t pp[H2R_SB_SUM], ids[H2R_NSUM], sa, ea, dt[H2R_NDT];
    if (l > 0) col.logs(l - 1, pp);
    else h2r_first_log(pp);
    const uint32_t e = col.enable(l);
    h2r_tag(pp, cur, e, ids, sa, ea, dt);
    const uint32_t changed = ids_changed(ids, next_sum);
    const uint32_t set_b = ea & changed, reset_b = ~ea & next_start & changed;
    y = (y & ~(set_b | reset_b)) | set_b;
    const uint32_t fwd = xs[(l - c0) * C_THREADS + t];
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
#elif H2R_POST_DIRECT
    // the fields' planes staged; at the lowest position l of a group
    // [l, l + n) the warp writes the group out
    const uint32_t flags[6] = {mask, fwd, y, e, sa, ea};
    uint32_t pl[H2R_DPLANES];
    h2r_direct_planes(flags, midsum, cur, e, pl);
    const int slot = (l - c0) & (DP - 1);
#pragma unroll
    for (int k = 0; k < H2R_DPLANES; ++k) stage[(k * DP + slot) * DPITCH + t] = pl[k];
    if (slot == 0) {
      __syncwarp();
      direct_write(stage, d_base, d_m, d_field, L, l, min(DP, c1 - l) / 4, t);
      __syncwarp();
    }
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
    for (int j = 0; j < H2R_SB_SUM; ++j) cur[j] = pp[j];
    next_start = sa;
    en_next = e;
  }
#if !H2R_POST_PLANES && !H2R_POST_DIRECT
  // strings whose first byte is disabled are empty (chunk 0 says so)
  uint32_t fbw[H2R_NDEFS * 8];
  h2r_fb(acc, c == 0 ? ~col.enable(0) : 0u, fbw);
#pragma unroll
  for (int k = 0; k < H2R_NDEFS * 8; ++k)
    if (fbw[k])
      atomicOr(reinterpret_cast<unsigned int*>(fb) +
                   ((size_t)nws * H2R_NDEFS * 8 + k) * H2R_LANE + lane,
               fbw[k]);
#endif
}

}  // namespace

// The three launches of one post call, in order: h2r_post_maps, then
// h2r_post_carry, then the mode's entry.  scr: [4, NCH, NW] int32,
// NCH = ceil(L / CL), 1 <= CL <= 32 (direct mode: a multiple of 4).
extern "C" int h2r_post_maps(const void* logs, const void* en, void* scr, int NW, int L,
                             int CL, void* stream) {
  if (CL < 1 || CL > CL_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((NW + THREADS - 1) / THREADS, (L + CL - 1) / CL);
  post_maps_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, (int32_t*)scr, NW, L, CL);
  return (int)cudaGetLastError();
}

extern "C" int h2r_post_carry(void* scr, int NW, int L, int CL, void* stream) {
  if (CL < 1 || CL > CL_MAX) return (int)cudaErrorInvalidValue;
  post_carry_kernel<<<(NW + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)scr, NW, (L + CL - 1) / CL);
  return (int)cudaGetLastError();
}

static int launch_post(const void* logs, const void* en, const void* tiled, const void* scr,
                       void* out, void* fb, int NW, int L, int CL, void* stream) {
  if (CL < 1 || CL > CL_MAX) return (int)cudaErrorInvalidValue;
  int smem = 0;
#if H2R_POST_DIRECT
  if (CL % 4 || L % 4 || NW % C_THREADS) return (int)cudaErrorInvalidValue;
  smem = DSTAGE_BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
#endif
  const dim3 grid((NW + C_THREADS - 1) / C_THREADS, (L + CL - 1) / CL);
  post_kernel<<<grid, C_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)logs, (const int32_t*)en, (const int32_t*)tiled, (const int32_t*)scr,
      (int32_t*)out, (int32_t*)fb, NW, L, CL);
  return (int)cudaGetLastError();
}

#if H2R_POST_PLANES
extern "C" int h2r_post_planes(const void* logs, const void* en, const void* scr, void* out,
                               int NW, int L, int CL, void* stream) {
  return launch_post(logs, en, nullptr, scr, out, nullptr, NW, L, CL, stream);
}
#elif H2R_POST_TILED
extern "C" int h2r_post_tiled(const void* logs, const void* en, const void* tiled,
                              const void* scr, void* g4, void* fb, int NW, int L, int CL,
                              void* stream) {
  return launch_post(logs, en, tiled, scr, g4, fb, NW, L, CL, stream);
}
#elif H2R_POST_DIRECT
// out: [NGROUPS, 8, NWS, 512, L / 4] int32, every byte written
extern "C" int h2r_post_direct(const void* logs, const void* en, const void* scr, void* out,
                               int NW, int L, int CL, void* stream) {
  return launch_post(logs, en, nullptr, scr, out, nullptr, NW, L, CL, stream);
}
#else
extern "C" int h2r_post(const void* logs, const void* en, const void* scr, void* g4, void* fb,
                        int NW, int L, int CL, void* stream) {
  return launch_post(logs, en, nullptr, scr, g4, fb, NW, L, CL, stream);
}
#endif
