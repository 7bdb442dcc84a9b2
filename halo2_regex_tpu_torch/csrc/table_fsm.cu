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
// per position and string, one int32 written per direction) when the
// strings fill the card; the latency of the loads when they do not (64
// strings in the 1K-state stress model: two warps' worth).  Two forms:
//
// One pass (CL = 0), when the strings alone fill the card: one launch for
// both directions, one thread a string, a warp on 32 consecutive strings
// (its loads and stores at one position are one 128-byte line).  The
// forward walk reads the three planes once, kPassStep positions loaded
// before they are used, writes fwd and packs each position's backward op
// into 2 bits; the backward walk reads only those codes (16 positions a
// word: 8 KiB a warp in shared memory at LS = 1024; a global scratch of
// [ceil(LS / 16), B] words, which stays in L2, for windows longer than
// 4096).  So the planes cross the bus once, as in the TPU kernel, which
// computes both directions from one read; a launch a direction read them
// twice, 32 B a position and string at n_defs = 1 against 20.  Measured on
// the H100 (kernel_ab.py, the from: planes at B=32768 x L=1024): 0.232 ms
// against 0.445 for a launch a direction.
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
// written; scratch: chunked [2, NCH, B] (forward, backward; NCH = ceil(LS /
// CL)), one pass [ceil(LS / 16), B] (the backward codes) or none.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxCL = 64;   // a chunk's backward ops fit one 64-bit mask
constexpr int kStep = 8;     // positions loaded before they are used (chunked)
constexpr int kWarps = 4;    // chunks a block of the chunked launches
constexpr int kPassStep = 16;  // positions loaded before they are used (one pass)
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

// The one-pass form's backward ops: 2 bits a position (0 hold, 1 set, 2
// reset), kCodeSpan positions a 32-bit word; word k of a string holds
// positions p0 + 16 k .. p0 + 16 k + 15, position p0 + 16 k + i at bits
// 2 i, 2 i + 1.
constexpr int kCodeSpan = 16;
// the most shared memory a warp's codes may take (LS <= 4096); longer
// windows keep them in a global scratch [ceil(LS / 16), B]
constexpr int kCodeSmemMax = 32 * 1024;
// the walk packs codes at constant shifts: its steps start at multiples of 16
static_assert(kPassStep % kCodeSpan == 0, "kPassStep must be a multiple of kCodeSpan");

// One warp per group of 32 strings (blockDim 32), the directions of DIRS
// (bit 0 forward, bit 1 backward) in one launch.  The forward walk reads
// ids, start and endf once, kPassStep positions loaded before they are
// used, writes fwd, and encodes the backward op of each position from
// what it has read: the op of p needs ids and start at p + 1, so it is
// known one step late, and the last one after the loop from the backward
// carry.  The backward walk then reads only the codes (shared memory,
// `codes` null, or the global scratch `codes`), descending from the
// backward entry, and writes bwd.  No thread reads another's codes: no
// barrier.  The walk is bound by its instructions as much as by its
// bytes (eight warps an SM at B = 32768, one thread a string), so the
// whole batches run without bound checks, the rows are reached by
// pointer steps, and the directions are template arguments; the last,
// partial batch clamps its loads and checks each position.
template <int DIRS>
__global__ void __launch_bounds__(kLanes)
table_fsm_pass_kernel(Planes pl, Carry cf, Carry cb, int32_t* __restrict__ fwd,
                      int32_t* __restrict__ bwd, uint32_t* __restrict__ codes) {
  constexpr bool kFwd = DIRS & 1, kBwd = DIRS & 2;
  extern __shared__ uint32_t smem_codes[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kLanes + lane;
  if (b >= pl.B) return;
  const size_t B = pl.B;
  size_t cstride = B;
  if (codes) {
    codes += b;
  } else {
    codes = smem_codes + lane;
    cstride = kLanes;
  }
  // ids and endf of the previous position (the forward carry's before the
  // first); the op of both directions turns on their change
  int nb_ids, nb_x;
  carry_sums(cf, pl.n_defs, b, nb_ids, nb_x);
  int x = kFwd && cf.entry ? cf.entry[b] : 0;
  uint32_t cw = 0;  // the code word being filled
  const size_t o0 = (size_t)pl.p0 * B + b;  // row p0, string b
  const int32_t* p_ids = pl.ids + o0;
  const int32_t* p_st = pl.start + o0;
  const int32_t* p_ef = pl.endf + o0;
  int32_t* p_fwd = kFwd ? fwd + o0 : nullptr;
  // one batch from position k (rows p_*): whole (every position < LS) or
  // the last, clamped and checked
  auto batch = [&](int k, auto whole) {
    constexpr bool kWhole = decltype(whole)::value;
    int si[kPassStep], ss[kPassStep], se[kPassStep];
#pragma unroll
    for (int j = 0; j < kPassStep; ++j) {  // def 0; no branch between the loads
      const size_t o = (size_t)(kWhole ? j : min(j, pl.LS - 1 - k)) * B;
      si[j] = __ldg(p_ids + o);
      ss[j] = __ldg(p_st + o);
      se[j] = __ldg(p_ef + o);
    }
    for (int d = 1; d < pl.n_defs; ++d) {
      const size_t dd = d * pl.plane;
#pragma unroll
      for (int j = 0; j < kPassStep; ++j) {
        const size_t o = dd + (size_t)(kWhole ? j : min(j, pl.LS - 1 - k)) * B;
        si[j] += __ldg(p_ids + o);
        ss[j] += __ldg(p_st + o);
        se[j] += __ldg(p_ef + o);
      }
    }
#pragma unroll
    for (int j = 0; j < kPassStep; ++j) {
      if (kWhole || k + j < pl.LS) {
        const bool changed = nb_ids != si[j];
        if (kFwd) {
          x = changed && ss[j] > 0 ? 1 : (changed && nb_x > 0 ? 0 : x);
          p_fwd[(size_t)j * B] = x;
        }
        if (kBwd && (j > 0 || k > 0)) {  // the backward op of position k + j - 1
          const uint32_t op = changed ? (nb_x > 0 ? 1u : (ss[j] > 0 ? 2u : 0u)) : 0u;
          cw |= op << (2 * ((j + kCodeSpan - 1) % kCodeSpan));  // k % 16 == 0
          if (j % kCodeSpan == 0) {  // position k + j - 1 ends a word
            codes[(size_t)((k + j - 1) / kCodeSpan) * cstride] = cw;
            cw = 0;
          }
        }
        nb_ids = si[j];
        nb_x = se[j];
      }
    }
    const size_t step = (size_t)kPassStep * B;
    p_ids += step;
    p_st += step;
    p_ef += step;
    if (kFwd) p_fwd += step;
  };
  const int whole = pl.LS / kPassStep * kPassStep;
  for (int k = 0; k < whole; k += kPassStep) batch(k, std::true_type{});
  if (whole < pl.LS) batch(whole, std::false_type{});
  if (!kBwd) return;
  {  // the last position's op, from the backward carry (ids, start at p0 + LS)
    int c_ids, c_st;
    carry_sums(cb, pl.n_defs, b, c_ids, c_st);
    const int q = pl.LS - 1;
    const uint32_t op = nb_ids != c_ids ? (nb_x > 0 ? 1u : (c_st > 0 ? 2u : 0u)) : 0u;
    codes[(size_t)(q / kCodeSpan) * cstride] = cw | op << (2 * (q % kCodeSpan));
  }
  int y = cb.entry ? cb.entry[b] : 0;
  for (int w = (pl.LS - 1) / kCodeSpan; w >= 0; --w) {
    const uint32_t c = codes[(size_t)w * cstride];
    int32_t* out = bwd + (size_t)(pl.p0 + w * kCodeSpan) * B + b;
#pragma unroll
    for (int i = kCodeSpan - 1; i >= 0; --i) {
      if (w * kCodeSpan + i < pl.LS) {
        const uint32_t op = (c >> (2 * i)) & 3u;
        y = op == 1u ? 1 : (op == 2u ? 0 : y);
        out[(size_t)i * B] = y;
      }
    }
  }
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
// one-pass form (one launch for both directions; scratch: null for the
// backward codes in shared memory, else the global code scratch [ceil(LS /
// 16), B]), else chunks of CL <= 64 positions (three launches; scratch [2,
// ceil(LS / CL), B]).
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
  if (CL == 0) {  // one launch for both directions
    const size_t smem =
        bo && !scratch ? (size_t)(LS + kCodeSpan - 1) / kCodeSpan * kLanes * 4 : 0;
    if (smem > kCodeSmemMax) return (int)cudaErrorInvalidValue;  // under the 48 KiB default
    auto kernel = dirs == 1 ? table_fsm_pass_kernel<1>
                  : dirs == 2 ? table_fsm_pass_kernel<2> : table_fsm_pass_kernel<3>;
    kernel<<<groups, kLanes, smem, st>>>(pl, cf, cb, fo, bo, (uint32_t*)scratch);
    return (int)cudaGetLastError();
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
