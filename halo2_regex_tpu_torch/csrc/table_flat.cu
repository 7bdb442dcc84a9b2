// table_flat -- the monolithic table-driven matcher: scan, pick and both
// mask FSMs in one kernel.
//
// Replaces the TPU kernel PallasMatcher._flat_kernel (B12,
// halo2_regex_tpu/ops/pallas_scan.py:509, _make_flat at :708, pallas_call
// at :713), the mode PallasMatcher resolves to when a def has more than
// max_pairs valid (prev, next) substring pairs: the pair tagging of split
// mode would then be a long list per position, so the scan picks, with
// each transition, its substring id and its start and end flags.  On the
// TPU each step is a one-hot bf16 MXU select of a packed
// [k, 4S] next | id | start | end class table, slab-unrolled, with
// joint-def tables; here a step is one gather of a packed int32 entry
//     next | id << 8 | start << 24 | endf << 25
// per (class, state) per def, the same integers.
//
// What bounds it on the H100: device-memory bytes (the six [n_defs, L, B] /
// [L, B] int32 outputs: 768 MiB at B=32768 x L=1024 for one def, against
// 32 MiB of input) and the serial chain of L dependent steps per string:
// the forward pass's shared-memory gathers.  What the design does about
// it: one thread per string, 64 a block, so B=32768 gives 512 blocks
// (about 4 a SM; balanced within one block's time) and each warp's stores
// at one position are one 128-byte line (time-major outputs).  The table
// (n_defs x K x S entries: 23.5 KiB for the 40-word dictionary model) is
// staged into shared memory once per block; the byte -> row offset maps
// (cls(c) * S) sit in static shared memory; the chars of a string come in
// 16-byte loads, two ahead of the chain.  The forward FSM runs in the scan
// loop.  The backward FSM needs, per position p in reverse order, three
// bits: changed_p (the id sum differs from position p + 1's, 0 past L),
// start_any_p and endf_any_p.  The forward pass packs them, 32 positions
// a word, into the bits scratch (changed_p is known one step later, when
// p + 1's sum is), one coalesced store per flag every 32 positions; the
// backward pass reads one word per flag per 32 positions and writes bwd
// once.  So the kernel moves 12 MiB of bit words each way at dict40 where
// an earlier design parked a full int32 a position in bwd (the id sum
// and both flags) and read it back: 256 MiB more.  A table too large for
// shared memory (a raw-bytes def, K = 256, at S = 256 needs 256 KiB, over
// the 227 KiB a block may have) is read from global memory through the
// read-only cache instead (smem_bytes = 0).  A model of more than
// kGroupDefs defs runs its scan once per group of kGroupDefs in the same
// launch (a def's state lives in a register, so the group bounds the
// registers): each group but the last adds its id sum and ORs its flags
// into a running column parked in bwd (isum << 2 | start_any | endf_any <<
// 1), and the last group's pass reads it back, completes the sums and
// runs the forward FSM and the bit packing as one group does.
//
// Layouts (int32 unless stated): chars [B, L] uint8; lengths [B]; cmap
// [n_defs, 256]; table [n_defs, K, S] packed entries; first [n_defs];
// states, ids, start, endf [n_defs, L, B]; fwd, bwd [L, B]; bits [3,
// ceil(L / 32), B] (scratch: flag k's word j of string b holds bit p - 32 j
// for positions p of [32 j, 32 j + 32); k: changed, start_any, endf_any).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kGroupDefs = 8;  // defs a pass of the scan carries
constexpr int kStage = 8;  // table loads in flight per thread while staging

// kGrouped: more than kGroupDefs defs.  The scan then runs once per group
// of at most kGroupDefs defs (their states in registers, their row offsets
// in the static map); each group but the last parks its id sum and flags
// in bwd, the last completes them and runs the forward FSM.
template <int kDefs, bool kSmem, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
table_flat_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ cmap, const int32_t* __restrict__ table,
                  const int32_t* __restrict__ first, int32_t* __restrict__ states,
                  int32_t* __restrict__ ids, int32_t* __restrict__ start,
                  int32_t* __restrict__ endf, int32_t* __restrict__ fwd,
                  int32_t* __restrict__ bwd, uint32_t* __restrict__ bits, int n_defs, int B,
                  int L, int K, int S, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t* tab = kSmem ? reinterpret_cast<const int32_t*>(smem) : table;
  __shared__ int row_off[kDefs * 256];  // (d * K + cls_d(c)) * S, d in the group
  if (kSmem) {
    int32_t* dst = reinterpret_cast<int32_t*>(smem);
    const int n = n_defs * K * S;
    const int n4 = (n & 3) == 0 && ((uintptr_t)table & 15) == 0 ? n / 4 : 0;
    const int4* src4 = reinterpret_cast<const int4*>(table);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kStage * blockDim.x) {
      int4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = __ldg(src4 + (i < n4 ? i : 0));
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n4) reinterpret_cast<int4*>(dst)[i] = v[u];
      }
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(table + i);
  }
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool live = b < B;  // every thread reaches each group's barriers
  const size_t plane = (size_t)L * B;
  const int len = live ? lengths[b] : 0;
  const uint8_t* row = chars + (size_t)b * L;
  // word j of flag k (changed, start_any, endf_any) at bw[k * bplane + j * B]
  const int NJ = (L + 31) / 32;
  const size_t bplane = (size_t)NJ * B;
  uint32_t* bw = bits + b;

  for (int g0 = 0; g0 < n_defs; g0 += kDefs) {
    const int nd = n_defs - g0 < kDefs ? n_defs - g0 : kDefs;
    const bool last = !kGrouped || g0 + kDefs >= n_defs;
    if (kGrouped && g0 > 0) __syncthreads();  // the last group's offsets are read
    for (int i = threadIdx.x; i < nd * 256; i += blockDim.x)
      row_off[i] = ((g0 + (i >> 8)) * K + cmap[g0 * 256 + i]) * S;
    __syncthreads();
    if (!live) continue;
    int s[kDefs];
#pragma unroll
    for (int d = 0; d < kDefs; ++d) s[d] = d < nd ? first[g0 + d] : 0;
    int prev_ids = 0, x = 0;
    bool prev_ef = false;
    uint32_t ch_w = 0, st_w = 0, ef_w = 0;  // the bit words being filled

    // one byte: every def's entry and its outputs; in the last group the
    // forward FSM and the backward pass's bits, else the parked column
    auto step = [&](int c, int p) {
      const bool en = p < len;
      int isum = 0, ssum = 0, esum = 0;
#pragma unroll
      for (int d = 0; d < kDefs; ++d) {
        if (d < nd) {
          const int idx = row_off[d * 256 + c] + s[d];
          uint32_t e;
          if constexpr (kSmem) {
            e = (uint32_t)tab[idx];
          } else {
            e = (uint32_t)__ldg(tab + idx);
          }
          s[d] = (int)(e & 0xFFu);
          const int id = en ? (int)((e >> 8) & 0xFFFFu) : 0;
          const int st = en ? (int)((e >> 24) & 1u) : 0;
          const int ef = en ? (int)((e >> 25) & 1u) : 0;
          const size_t o = (g0 + d) * plane + (size_t)p * B + b;
          states[o] = s[d];
          ids[o] = id;
          start[o] = st;
          endf[o] = ef;
          isum += id;
          ssum += st;
          esum += ef;
        }
      }
      const size_t q = (size_t)p * B + b;
      bool st_any = ssum > 0, ef_any = esum > 0;
      if constexpr (kGrouped) {
        if (g0 > 0) {  // the earlier groups' id sum and flags
          const int old = bwd[q];
          isum += old >> 2;
          st_any |= old & 1;
          ef_any |= (old >> 1) & 1;
        }
        if (!last) {
          bwd[q] = (isum << 2) | (int)st_any | (int)ef_any << 1;
          return;
        }
      }
      // forward FSM (src/lib.rs:598-645)
      const bool changed = prev_ids != isum;
      x = st_any && changed ? 1 : (!st_any && prev_ef && changed ? 0 : x);
      fwd[q] = x;
      // changed is position p - 1's backward bit (its sum against p's)
      if (p > 0) {
        const int r = (p - 1) & 31;
        ch_w |= (uint32_t)changed << r;
        if (r == 31) {
          bw[((p - 1) >> 5) * B] = ch_w;
          ch_w = 0;
        }
      }
      const int r = p & 31;
      st_w |= (uint32_t)st_any << r;
      ef_w |= (uint32_t)ef_any << r;
      if (r == 31) {
        bw[bplane + (p >> 5) * B] = st_w;
        bw[2 * bplane + (p >> 5) * B] = ef_w;
        st_w = ef_w = 0;
      }
      prev_ids = isum;
      prev_ef = ef_any;
    };

    if (vec) {
      // 16 bytes a load, the next chunk loaded while this one steps
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const int n16 = L / 16;
      uint4 cur = __ldg(row4);
      for (int i = 0; i < n16; ++i) {
        const uint4 nxt = __ldg(row4 + (i + 1 < n16 ? i + 1 : i));
        const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) step((int)((w[j >> 2] >> (8 * (j & 3))) & 0xFFu), 16 * i + j);
        cur = nxt;
      }
    } else {
      for (int p = 0; p < L; ++p) step(row[p], p);
    }
    if (last) {
      // position L - 1's changed bit (the id sum past L is 0) and the
      // last, partial words
      const int p = L - 1, r = p & 31;
      ch_w |= (uint32_t)(prev_ids != 0) << r;
      bw[(p >> 5) * B] = ch_w;
      if (r != 31) {
        bw[bplane + (p >> 5) * B] = st_w;
        bw[2 * bplane + (p >> 5) * B] = ef_w;
      }
    }
  }
  if (!live) return;

  // backward FSM (src/lib.rs:663-714) from the bits, descending; the
  // next word's bits load while this word's positions step
  int y = 0;
  uint32_t next_st = 0;
  uint32_t cw = bw[(NJ - 1) * B], sw = bw[bplane + (NJ - 1) * B];
  uint32_t ew = bw[2 * bplane + (NJ - 1) * B];
  for (int j = NJ - 1; j >= 0; --j) {
    const int jn = j > 0 ? j - 1 : 0;
    const uint32_t cn = bw[jn * B], sn = bw[bplane + jn * B], wn = bw[2 * bplane + jn * B];
    const int n = L - 32 * j < 32 ? L - 32 * j : 32;
    int32_t* o = bwd + (size_t)(32 * j) * B + b;
#pragma unroll
    for (int k = 31; k >= 0; --k) {
      if (k < n) {
        const bool changed = (cw >> k) & 1u, ef_any = (ew >> k) & 1u;
        y = ef_any && changed ? 1 : (!ef_any && next_st && changed ? 0 : y);
        o[(size_t)k * B] = y;
        next_st = (sw >> k) & 1u;
      }
    }
    cw = cn;
    sw = sn;
    ew = wn;
  }
}

template <int kDefs, bool kGrouped>
int launch(bool smem, const void* chars, const void* lengths, const void* cmap,
           const void* table, const void* first, void* states, void* ids, void* start,
           void* endf, void* fwd, void* bwd, void* bits, int n_defs, int B, int L, int K, int S,
           int vec, int smem_bytes, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads);
#define H2R_FLAT_ARGS                                                                       \
  (const uint8_t*)chars, (const int32_t*)lengths, (const int32_t*)cmap,                    \
      (const int32_t*)table, (const int32_t*)first, (int32_t*)states, (int32_t*)ids,       \
      (int32_t*)start, (int32_t*)endf, (int32_t*)fwd, (int32_t*)bwd, (uint32_t*)bits, n_defs,  \
      B, L, K, S, vec
  if (smem) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          table_flat_kernel<kDefs, true, kGrouped>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    table_flat_kernel<kDefs, true, kGrouped><<<grid, kThreads, smem_bytes, stream>>>(
        H2R_FLAT_ARGS);
  } else {
    table_flat_kernel<kDefs, false, kGrouped><<<grid, kThreads, 0, stream>>>(H2R_FLAT_ARGS);
  }
#undef H2R_FLAT_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// smem_bytes: the table's bytes (staged in shared memory), or 0 (read from
// global memory).  n_defs: any positive count; beyond kGroupDefs the scan
// runs in groups.  bits: the [3, ceil(L / 32), B] int32 scratch.
extern "C" int h2r_table_flat(const void* chars, const void* lengths, const void* cmap,
                              const void* table, const void* first, void* states, void* ids,
                              void* start, void* endf, void* fwd, void* bwd, void* bits,
                              int n_defs, int B, int L, int K, int S, int vec, int smem_bytes,
                              void* stream) {
  if (n_defs < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const bool smem = smem_bytes > 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_defs == 1)
    return launch<1, false>(smem, chars, lengths, cmap, table, first, states, ids, start, endf, fwd,
                            bwd, bits, n_defs, B, L, K, S, vec, smem_bytes, st);
  if (n_defs == 2)
    return launch<2, false>(smem, chars, lengths, cmap, table, first, states, ids, start, endf, fwd,
                            bwd, bits, n_defs, B, L, K, S, vec, smem_bytes, st);
  if (n_defs <= 4)
    return launch<4, false>(smem, chars, lengths, cmap, table, first, states, ids, start, endf, fwd,
                            bwd, bits, n_defs, B, L, K, S, vec, smem_bytes, st);
  if (n_defs <= kGroupDefs)
    return launch<8, false>(smem, chars, lengths, cmap, table, first, states, ids, start, endf,
                            fwd, bwd, bits, n_defs, B, L, K, S, vec, smem_bytes, st);
  return launch<kGroupDefs, true>(smem, chars, lengths, cmap, table, first, states, ids, start,
                                  endf, fwd, bwd, bits, n_defs, B, L, K, S, vec, smem_bytes, st);
}
