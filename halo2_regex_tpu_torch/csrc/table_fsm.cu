// table_fsm -- the forward and backward mask FSMs of the split matcher.
//
// Replaces the TPU kernels PallasMatcher._fsm_kernel (B10,
// halo2_regex_tpu/ops/pallas_scan.py:898, pallas_call at :1013) and the
// segmented _fsm_kernel_seg_fwd / _fsm_kernel_seg_bwd (B11, :1145 / :1168,
// pallas_call at :1240); one kernel with a direction argument.  Per string
// it sums the per-def ids / start / endf over defs and runs the
// set/reset/hold recurrence of the reference (src/lib.rs:598-714) over the
// window [p0, p0 + LS):
//   forward:  changed = ids[p-1] != ids[p];
//             x = start[p] > 0 && changed ? 1
//               : start[p] == 0 && endf[p-1] > 0 && changed ? 0 : x
//   backward (p descending): changed = ids[p+1] != ids[p];
//             x = endf[p] > 0 && changed ? 1
//               : endf[p] == 0 && start[p+1] > 0 && changed ? 0 : x
// From the carries: entry (the mask beside the window; null = 0) and the
// per-def rows beside it, carry_ids and carry_x (endf forward, start
// backward; null = 0 at the ends of L).
//
// What bounds it on the H100: device-memory bytes (3 x n_defs int32 read
// and one written per position and string) when the batch fills the card;
// the latency of the loads when it does not (64 strings in the 1K-state
// stress model: two warps' worth of strings).  Design: each step is a map
// x -> x, 1 or 0, and maps compose, so a string's window is cut into
// n_chunks chunks, one warp each (32 consecutive strings per warp, so a
// warp's loads and stores at one position are one 128-byte line).  Pass 1
// composes each chunk's map, one thread per (string, chunk); the chunk
// entries are then chained in shared memory (n_chunks steps); pass 2 walks
// each chunk again from its entry and writes the mask.  The TPU's
// Hillis-Steele log-scan over the whole window is this with chunks of one
// position.  The wrapper's n_chunks is 1 when the batch alone fills the
// card (then pass 1 is skipped and the planes are read once).  Each pass
// loads kStep positions of a def's three planes before it uses them, so
// 3 x kStep loads are in flight per thread: 8 positions when 32 chunks
// share a block's registers, 32 when one warp walks the whole window.
//
// Layouts (int32): ids, start, endf [n_defs, L, B]; entry [B]; carry_ids,
// carry_x [n_defs, B] with row stride carry_ds; out [L, B], rows p0 ..
// p0 + LS - 1 written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;      // strings per block
constexpr int kMaxChunks = 32;  // warps per block

struct Planes {
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
// nb_x) of step k0 - 1, loading kStep positions at a time.  kApply: x runs
// the recurrence and each step's x is stored; else (h, v) composes the
// steps' map x -> h ? x : v.
template <bool kApply, int kStep>
__device__ __forceinline__ void walk(const Planes& pl, int b, int k0, int k1, int nb_ids,
                                     int nb_x, int& x, int& h, int& v, int32_t* out) {
  for (int k = k0; k < k1; k += kStep) {
    int si[kStep], sd[kStep], sn[kStep];
#pragma unroll
    for (int j = 0; j < kStep; ++j) si[j] = sd[j] = sn[j] = 0;
    for (int d = 0; d < pl.n_defs; ++d) {
#pragma unroll
      for (int j = 0; j < kStep; ++j) {  // clamped: no branch between the loads
        const size_t o = d * pl.plane + (size_t)pl.pos(min(k + j, k1 - 1)) * pl.B + b;
        si[j] += __ldg(pl.ids + o);
        sd[j] += __ldg(pl.dec + o);
        sn[j] += __ldg(pl.nbr + o);
      }
    }
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if (k + j < k1) {
        // op: 1 set, 2 reset, 0 hold
        const int op = nb_ids == si[j] ? 0 : (sd[j] > 0 ? 1 : (nb_x > 0 ? 2 : 0));
        if (kApply) {
          x = op == 1 ? 1 : (op == 2 ? 0 : x);
          out[(size_t)pl.pos(k + j) * pl.B + b] = x;
        } else if (op) {
          h = 0;
          v = op == 1;
        }
        nb_ids = si[j];
        nb_x = sn[j];
      }
    }
  }
}

// kChunks > 1: up to kChunks chunks per string, kStep = 8 (64 registers
// at 1024 threads); kChunks = 1: one warp per string group, kStep = 32.
template <int kChunks, int kStep>
__global__ void __launch_bounds__(kLanes * kChunks)
table_fsm_kernel(Planes pl, const int32_t* __restrict__ entry,
                 const int32_t* __restrict__ carry_ids, const int32_t* __restrict__ carry_x,
                 long long carry_ds, int32_t* __restrict__ out) {
  __shared__ int chunk_h[kChunks][kLanes], chunk_v[kChunks][kLanes];
  __shared__ int chunk_in[kChunks][kLanes];
  const int lane = threadIdx.x, c = threadIdx.y, n_chunks = blockDim.y;
  const int b = blockIdx.x * kLanes + lane;
  const bool live = b < pl.B;
  const int per = (pl.LS + n_chunks - 1) / n_chunks;
  const int k0 = min(c * per, pl.LS), k1 = min(k0 + per, pl.LS);

  // the neighbour sums of step k0 - 1: the carry rows, or the previous chunk
  int nb_ids = 0, nb_x = 0;
  if (live && k0 == 0 && carry_ids) {
    for (int d = 0; d < pl.n_defs; ++d) {
      nb_ids += carry_ids[(size_t)d * carry_ds + b];
      nb_x += carry_x[(size_t)d * carry_ds + b];
    }
  } else if (live && k0 > 0) {
    const size_t o = (size_t)pl.pos(k0 - 1) * pl.B + b;
    for (int d = 0; d < pl.n_defs; ++d) {
      nb_ids += __ldg(pl.ids + d * pl.plane + o);
      nb_x += __ldg(pl.nbr + d * pl.plane + o);
    }
  }
  int x = 0, h = 1, v = 0;
  if (kChunks > 1) {
    if (live) walk<false, kStep>(pl, b, k0, k1, nb_ids, nb_x, x, h, v, nullptr);
    chunk_h[c][lane] = h;
    chunk_v[c][lane] = v;
    __syncthreads();
    if (c == 0) {
      int e = live && entry ? entry[b] : 0;
      for (int i = 0; i < n_chunks; ++i) {
        chunk_in[i][lane] = e;
        e = chunk_h[i][lane] ? e : chunk_v[i][lane];
      }
    }
    __syncthreads();
    x = chunk_in[c][lane];
  } else if (live && entry) {
    x = entry[b];
  }
  if (live) walk<true, kStep>(pl, b, k0, k1, nb_ids, nb_x, x, h, v, out);
}

}  // namespace

// n_chunks: warps per string group (1..32).
extern "C" int h2r_table_fsm(int reverse, const void* ids, const void* start, const void* endf,
                             const void* entry, const void* carry_ids, const void* carry_x,
                             long long carry_ds, void* out, int n_defs, int B, int L, int p0,
                             int LS, int n_chunks, void* stream) {
  if (n_chunks < 1 || n_chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  Planes pl;
  pl.ids = (const int32_t*)ids;
  pl.dec = (const int32_t*)(reverse ? endf : start);
  pl.nbr = (const int32_t*)(reverse ? start : endf);
  pl.plane = (size_t)L * B;
  pl.n_defs = n_defs;
  pl.B = B;
  pl.p0 = p0;
  pl.LS = LS;
  pl.reverse = reverse;
  const dim3 block(kLanes, n_chunks), grid((B + kLanes - 1) / kLanes);
  if (n_chunks > 1) {
    table_fsm_kernel<kMaxChunks, 8><<<grid, block, 0, (cudaStream_t)stream>>>(
        pl, (const int32_t*)entry, (const int32_t*)carry_ids, (const int32_t*)carry_x,
        carry_ds, (int32_t*)out);
  } else {
    table_fsm_kernel<1, 32><<<grid, block, 0, (cudaStream_t)stream>>>(
        pl, (const int32_t*)entry, (const int32_t*)carry_ids, (const int32_t*)carry_x,
        carry_ds, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
