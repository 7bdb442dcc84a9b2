// table_fsm -- the forward and backward mask FSMs of the split matcher.
//
// Replaces the TPU kernels PallasMatcher._fsm_kernel (B10,
// halo2_regex_tpu/ops/pallas_scan.py:898, pallas_call at :1013) and the
// segmented _fsm_kernel_seg_fwd / _fsm_kernel_seg_bwd (B11, :1145 / :1168,
// pallas_call at :1240).  Per string it sums the per-def ids / start / endf
// over defs and runs the set/reset/hold recurrences of the reference
// (src/lib.rs:598-714) over the window [p0, p0 + LS):
//   forward:  changed = ids[p-1] != ids[p];
//             x = start[p] > 0 && changed ? 1
//               : start[p] == 0 && endf[p-1] > 0 && changed ? 0 : x
//   backward (p descending): changed = ids[p+1] != ids[p];
//             x = endf[p] > 0 && changed ? 1
//               : endf[p] == 0 && start[p+1] > 0 && changed ? 0 : x
// From the carries of each direction: entry (the mask beside the window;
// null = 0) and the per-def rows beside it, carry ids and carry x (endf
// forward, start backward; null = 0 at the ends of L).  One call runs
// either direction or both (dirs: bit 0 forward, bit 1 backward).
//
// What bounds it on the H100: device-memory bytes (3 x n_defs int32 read
// and one written per position, string and direction) when the strings
// fill the card; the latency of the loads when they do not (64 strings in
// the 1K-state stress model: two warps' worth).  Two forms:
//
// One pass (CL = 0), when the strings alone fill the card: one thread a
// string walks the window, loading kPassStep positions of the three
// planes before it uses them, one launch a direction (PR 6's form); a
// warp on 32 consecutive strings, so its loads and stores at one position
// are one 128-byte line.
//
// Chunked (CL > 0), at any window length and batch: each step is a map
// x -> x, 1 or 0, and maps compose, so the window is cut into chunks of CL
// <= 64 positions spread over the card, in three launches (the scheme of
// bitplane_post.cu):
//   A, maps: one thread per (string, chunk) reads the chunk's planes once,
//     ascending, and composes both directions' maps: forward, the last
//     position whose op is not hold; backward (walked descending), the
//     first one.  -1 stands for hold (the identity), else the constant;
//   B, carries: one warp per (string, direction) chains the chunk maps in
//     walk order from the entry (a warp-wide scan of compositions: each
//     lane composes a run of chunks, the lanes' maps are scanned with
//     shuffles) and overwrites each map with its chunk's carry-in;
//   C, replay: one thread per (string, chunk) walks its chunk ascending
//     from the forward carry-in, writing fwd, and keeps the backward ops as
//     two 64-bit masks, then writes bwd descending from the backward
//     carry-in.
// A and C each read the planes once for both directions.
//
// Layouts (int32): ids, start, endf [n_defs, L, B]; entries [B]; carry rows
// [n_defs, B] with row stride *_ds; fwd, bwd [L, B], rows p0 .. p0 + LS - 1
// written; scratch [2, NCH, B] (forward, backward; NCH = ceil(LS / CL)).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCL = 64;   // a chunk's backward ops fit one 64-bit mask
constexpr int kStep = 8;     // positions loaded before they are used (chunked)
constexpr int kWarps = 4;    // chunks a block of the chunked launches
constexpr int kPassStep = 32;  // positions loaded before they are used (one pass)
constexpr int kBatch = 8;      // chunk maps a lane of the carry launch loads at a time

struct Planes {
  const int32_t* ids;
  const int32_t* start;
  const int32_t* endf;
  size_t plane;
  int n_defs, B, p0, LS;
};

// the mask beside the window and the per-def rows beside it
struct Carry {
  const int32_t* entry;
  const int32_t* ids;
  const int32_t* x;
  long long ds;
};

__device__ __forceinline__ void carry_sums(const Carry& c, int n_defs, int b, int& i, int& x) {
  i = 0;
  x = 0;
  if (c.ids)
    for (int d = 0; d < n_defs; ++d) {
      i += c.ids[(size_t)d * c.ds + b];
      x += c.x[(size_t)d * c.ds + b];
    }
}

// The sums over defs of ids, start and endf at position p.
__device__ __forceinline__ void sums(const Planes& pl, int p, int b, int& i, int& st, int& ef) {
  i = st = ef = 0;
  const size_t o = (size_t)p * pl.B + b;
  for (int d = 0; d < pl.n_defs; ++d) {
    i += __ldg(pl.ids + d * pl.plane + o);
    st += __ldg(pl.start + d * pl.plane + o);
    ef += __ldg(pl.endf + d * pl.plane + o);
  }
}

// op of a step: 1 set, 0 reset, -1 hold; dec is the position's deciding
// flag (start forward, endf backward), nb_* the neighbour's sums in walk
// order (ids and endf of p - 1 forward, ids and start of p + 1 backward)
__device__ __forceinline__ int op_of(int ids, int dec, int nb_ids, int nb_x) {
  return nb_ids == ids ? -1 : (dec > 0 ? 1 : (nb_x > 0 ? 0 : -1));
}

// ---------------------------------------------------------------- one pass

// One direction's planes, as the one-pass walk reads them.  This form is
// PR 6's kernel as it was: rewritten with constant walk bounds and the
// chunked form's op encoding, nvcc laid its loop out otherwise and it ran
// at half the rate (kernel_ab.py).
struct PassPlanes {
  const int32_t* ids;
  const int32_t* dec;  // the deciding flag: start forward, endf backward
  const int32_t* nbr;  // the neighbour's flag: endf forward, start backward
  size_t plane;
  int n_defs, B, p0, LS, reverse;

  // the position of walk step k (0 = the first position the FSM visits)
  __device__ __forceinline__ int pos(int k) const {
    return reverse ? p0 + LS - 1 - k : p0 + k;
  }
};

// Walks steps [k0, k1) of one string from the neighbour sums (nb_ids,
// nb_x) of step k0 - 1, loading kPassStep positions at a time; each step's
// x is stored.
__device__ __forceinline__ void pass_walk(const PassPlanes& pl, int b, int k0, int k1,
                                          int nb_ids, int nb_x, int& x, int32_t* out) {
  for (int k = k0; k < k1; k += kPassStep) {
    int si[kPassStep], sd[kPassStep], sn[kPassStep];
#pragma unroll
    for (int j = 0; j < kPassStep; ++j) si[j] = sd[j] = sn[j] = 0;
    for (int d = 0; d < pl.n_defs; ++d) {
#pragma unroll
      for (int j = 0; j < kPassStep; ++j) {  // clamped: no branch between the loads
        const size_t o = d * pl.plane + (size_t)pl.pos(min(k + j, k1 - 1)) * pl.B + b;
        si[j] += __ldg(pl.ids + o);
        sd[j] += __ldg(pl.dec + o);
        sn[j] += __ldg(pl.nbr + o);
      }
    }
#pragma unroll
    for (int j = 0; j < kPassStep; ++j) {
      if (k + j < k1) {
        // op: 1 set, 2 reset, 0 hold
        const int op = nb_ids == si[j] ? 0 : (sd[j] > 0 ? 1 : (nb_x > 0 ? 2 : 0));
        x = op == 1 ? 1 : (op == 2 ? 0 : x);
        out[(size_t)pl.pos(k + j) * pl.B + b] = x;
        nb_ids = si[j];
        nb_x = sn[j];
      }
    }
  }
}

// One warp per group of 32 strings (blockDim (32, 1)): the whole window in
// one direction.
__global__ void __launch_bounds__(kLanes)
table_fsm_pass_kernel(PassPlanes pl, const int32_t* __restrict__ entry,
                      const int32_t* __restrict__ carry_ids,
                      const int32_t* __restrict__ carry_x, long long carry_ds,
                      int32_t* __restrict__ out) {
  const int lane = threadIdx.x, c = threadIdx.y, n_chunks = blockDim.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < pl.B;
  const int per = (pl.LS + n_chunks - 1) / n_chunks;
  const int k0 = min(c * per, pl.LS), k1 = min(k0 + per, pl.LS);
  int nb_ids = 0, nb_x = 0;
  if (live && k0 == 0 && carry_ids) {
    for (int d = 0; d < pl.n_defs; ++d) {
      nb_ids += carry_ids[(size_t)d * carry_ds + b];
      nb_x += carry_x[(size_t)d * carry_ds + b];
    }
  }
  int x = 0;
  if (live && entry) x = entry[b];
  if (live) pass_walk(pl, b, k0, k1, nb_ids, nb_x, x, out);
}

// ----------------------------------------------------------------- chunked

// The chunk of (b, c): [cs, ce) and the sums at cs - 1 (ids, endf: the
// forward neighbour of cs) and at ce (ids, start: the backward neighbour of
// ce - 1), from the planes or the carries at the window's ends.
struct Chunk {
  int cs, ce, prev_ids, prev_ef, next_ids, next_st;
};

__device__ __forceinline__ Chunk chunk_of(const Planes& pl, const Carry& cf, const Carry& cb,
                                          int b, int c, int CL) {
  Chunk k;
  k.cs = pl.p0 + c * CL;
  k.ce = min(k.cs + CL, pl.p0 + pl.LS);
  int st;
  if (k.cs > pl.p0) {
    sums(pl, k.cs - 1, b, k.prev_ids, st, k.prev_ef);
  } else {
    carry_sums(cf, pl.n_defs, b, k.prev_ids, k.prev_ef);
  }
  int ef;
  if (k.ce < pl.p0 + pl.LS) {
    sums(pl, k.ce, b, k.next_ids, k.next_st, ef);
  } else {
    carry_sums(cb, pl.n_defs, b, k.next_ids, k.next_st);
  }
  return k;
}

// Walks chunk k ascending, kStep positions of the planes loaded at a time.
// Each position's forward op and the backward op of the position before
// it (the last one's after the loop, from the next sums) are handed to
// visit(j, fop) and visit_b(j, bop), j the index in the chunk.
template <typename F, typename G>
__device__ __forceinline__ void chunk_walk(const Planes& pl, const Chunk& k, int b, F visit,
                                           G visit_b) {
  // ids, endf at the previous position (pe: the forward neighbour's endf,
  // the carry's before the first position; pf: the plane's, for the
  // backward op of that position)
  int pi = k.prev_ids, pe = k.prev_ef, pf = 0;
  const int n = k.ce - k.cs;
#pragma unroll
  for (int j0 = 0; j0 < kMaxCL; j0 += kStep) {
    if (j0 < n) {
      int si[kStep], ss[kStep], se[kStep];
#pragma unroll
      for (int j = 0; j < kStep; ++j) si[j] = ss[j] = se[j] = 0;
      for (int d = 0; d < pl.n_defs; ++d) {
#pragma unroll
        for (int j = 0; j < kStep; ++j) {  // clamped: no branch between the loads
          const size_t o = d * pl.plane + (size_t)(k.cs + min(j0 + j, n - 1)) * pl.B + b;
          si[j] += __ldg(pl.ids + o);
          ss[j] += __ldg(pl.start + o);
          se[j] += __ldg(pl.endf + o);
        }
      }
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        if (j0 + j < n) {
          visit(j0 + j, op_of(si[j], ss[j], pi, pe));
          if (j0 + j > 0) visit_b(j0 + j - 1, op_of(pi, pf, si[j], ss[j]));
          pi = si[j];
          pe = pf = se[j];
        }
      }
    }
  }
  visit_b(n - 1, op_of(pi, pf, k.next_ids, k.next_st));
}

// A: both directions' maps of chunk (b, c).
__global__ void __launch_bounds__(kLanes * kWarps)
table_fsm_maps_kernel(Planes pl, Carry cf, Carry cb, int32_t* __restrict__ scr, int CL) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int c = blockIdx.y * kWarps + threadIdx.y;
  const int n_ch = (pl.LS + CL - 1) / CL;
  if (b >= pl.B || c >= n_ch) return;
  const Chunk k = chunk_of(pl, cf, cb, b, c, CL);
  int fm = -1, bm = -1;
  chunk_walk(pl, k, b, [&](int, int op) { fm = op < 0 ? fm : op; },
             [&](int, int op) { bm = bm >= 0 || op < 0 ? bm : op; });
  scr[(size_t)c * pl.B + b] = fm;
  scr[((size_t)n_ch + c) * pl.B + b] = bm;
}

// B: one warp per (string, direction); chunks in walk order: ascending
// forward, descending backward.
__global__ void __launch_bounds__(kLanes * kWarps)
table_fsm_carry_kernel(int32_t* __restrict__ scr, const int32_t* __restrict__ entry_f,
                       const int32_t* __restrict__ entry_b, int B, int n_ch, int dirs) {
  const int lane = threadIdx.x;
  const int w = blockIdx.x * kWarps + threadIdx.y;
  const int b = w >> 1, reverse = w & 1;
  if (b >= B || !((dirs >> reverse) & 1)) return;
  int32_t* m = scr + (size_t)reverse * n_ch * B + b;
  const int per = (n_ch + kLanes - 1) / kLanes;
  const int k0 = min(lane * per, n_ch), k1 = min(k0 + per, n_ch);
  // the lane's run, kBatch maps loaded at a time, composed in walk order
  int acc = -1;
  for (int k = k0; k < k1; k += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = k + j < k1 ? m[(size_t)(reverse ? n_ch - 1 - k - j : k + j) * B] : -1;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) acc = v[j] < 0 ? acc : v[j];
  }
  int incl = acc;  // lanes 0..lane composed
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o && incl < 0) incl = u;
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  const int32_t* entry = reverse ? entry_b : entry_f;
  int e = entry ? entry[b] : 0;
  if (lane > 0 && excl >= 0) e = excl;
  for (int k = k0; k < k1; k += kBatch) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      v[j] = k + j < k1 ? m[(size_t)(reverse ? n_ch - 1 - k - j : k + j) * B] : -1;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (k + j < k1) m[(size_t)(reverse ? n_ch - 1 - k - j : k + j) * B] = e;
      e = v[j] < 0 ? e : v[j];
    }
  }
}

// C: replay chunk (b, c) from its carry-ins.
__global__ void __launch_bounds__(kLanes * kWarps)
table_fsm_replay_kernel(Planes pl, Carry cf, Carry cb, const int32_t* __restrict__ scr, int CL,
                        int32_t* __restrict__ fwd, int32_t* __restrict__ bwd) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int c = blockIdx.y * kWarps + threadIdx.y;
  const int n_ch = (pl.LS + CL - 1) / CL;
  if (b >= pl.B || c >= n_ch) return;
  const Chunk k = chunk_of(pl, cf, cb, b, c, CL);
  int x = scr[(size_t)c * pl.B + b];
  unsigned long long hold = ~0ull, val = 0;  // the backward ops, bit j = position cs + j
  int32_t* fo = fwd ? fwd + (size_t)k.cs * pl.B + b : nullptr;
  chunk_walk(
      pl, k, b,
      [&](int j, int op) {
        x = op < 0 ? x : op;
        if (fo) fo[(size_t)j * pl.B] = x;
      },
      [&](int j, int op) {
        if (op >= 0) {
          hold &= ~(1ull << j);
          val |= (unsigned long long)op << j;
        }
      });
  if (!bwd) return;
  int y = scr[((size_t)n_ch + c) * pl.B + b];
  int32_t* bo = bwd + (size_t)k.cs * pl.B + b;
  const int n = k.ce - k.cs;
#pragma unroll
  for (int j = kMaxCL - 1; j >= 0; --j) {
    if (j < n) {
      y = (hold >> j) & 1 ? y : (int)((val >> j) & 1);
      bo[(size_t)j * pl.B] = y;
    }
  }
}

}  // namespace

// dirs: bit 0 forward (into fwd), bit 1 backward (into bwd); CL = 0: the
// one-pass form (one launch a direction), else chunks of CL <= 64
// positions (three launches; scratch [2, ceil(LS / CL), B]).
extern "C" int h2r_table_fsm(int dirs, const void* ids, const void* start, const void* endf,
                             const void* f_entry, const void* f_ids, const void* f_x,
                             long long f_ds, const void* b_entry, const void* b_ids,
                             const void* b_x, long long b_ds, void* fwd, void* bwd,
                             void* scratch, int n_defs, int B, int L, int p0, int LS, int CL,
                             void* stream) {
  if (dirs < 1 || dirs > 3 || CL < 0 || CL > kMaxCL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Planes pl{(const int32_t*)ids, (const int32_t*)start, (const int32_t*)endf,
                  (size_t)L * B, n_defs, B, p0, LS};
  const Carry cf{(const int32_t*)f_entry, (const int32_t*)f_ids, (const int32_t*)f_x, f_ds};
  const Carry cb{(const int32_t*)b_entry, (const int32_t*)b_ids, (const int32_t*)b_x, b_ds};
  int32_t* fo = (dirs & 1) ? (int32_t*)fwd : nullptr;
  int32_t* bo = (dirs & 2) ? (int32_t*)bwd : nullptr;
  const unsigned groups = (unsigned)((B + kLanes - 1) / kLanes);
  if (CL == 0) {  // one launch a direction
    for (int dir = 0; dir < 2; ++dir) {
      if (!((dirs >> dir) & 1)) continue;
      const PassPlanes pp{pl.ids, dir ? pl.endf : pl.start, dir ? pl.start : pl.endf,
                          pl.plane, n_defs, B, p0, LS, dir};
      const Carry& c = dir ? cb : cf;
      table_fsm_pass_kernel<<<groups, dim3(kLanes, 1), 0, st>>>(pp, c.entry, c.ids, c.x, c.ds,
                                                                dir ? bo : fo);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  const int n_ch = (LS + CL - 1) / CL;
  int32_t* scr = (int32_t*)scratch;
  const dim3 block(kLanes, kWarps), grid(groups, (n_ch + kWarps - 1) / kWarps);
  table_fsm_maps_kernel<<<grid, block, 0, st>>>(pl, cf, cb, scr, CL);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned warps = 2u * (unsigned)B;
  table_fsm_carry_kernel<<<(warps + kWarps - 1) / kWarps, block, 0, st>>>(
      scr, (const int32_t*)f_entry, (const int32_t*)b_entry, B, n_ch, dirs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  table_fsm_replay_kernel<<<grid, block, 0, st>>>(pl, cf, cb, scr, CL, fo, bo);
  return (int)cudaGetLastError();
}
