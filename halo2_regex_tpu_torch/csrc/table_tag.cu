// table_tag -- substring ids and start/end flags of the split matcher.
//
// Replaces the TPU kernels PallasMatcher._tag_kernel (B9,
// halo2_regex_tpu/ops/pallas_scan.py:866, pallas_call at :993) and
// _tag_kernel_seg (B11, :1090, pallas_call at :1219).  ids, is_start and
// is_end are functions of the (prev, next) state pair alone: for each def
// d, position p of the window [p0, p0 + LS) and string b, the pair
// (states[d, p - 1, b], states[d, p, b]) (prev[d, b] at p = p0: the first
// states, or the previous segment's last row) is looked up in the def's
// list of valid pairs (a, b, gid, is_start, is_end), and the hit, if any,
// is written masked by p < lengths[b].  Pairs are unique, so the TPU
// kernel's sum over matching pairs has at most one term.
//
// What bounds it on the H100: device-memory bytes (4 B of states read and
// 12 B written per position and string), with a linear search of a few
// dozen compares per element beside them.  Design: one thread per run of
// kRun consecutive positions of one string (so each state is loaded once,
// the run's first neighbour aside), a warp on 32 consecutive strings of
// one run, so every load and store is one 128-byte line; the pair list
// sits in shared memory as 64-bit (a, b) keys and packed values, read by
// every thread of a warp at the same address (a broadcast).  A def with no pairs (P = 0)
// still writes its zeros, as the TPU kernel does.  The first kSmemPairs =
// 4096 pairs (48 KiB) are staged; a longer list's tail is searched in
// global memory, where every thread of a warp also reads one address
// (a broadcast through L1), so any list length runs.
//
// Layouts (int32): states, ids, start, endf [n_defs, L, B]; prev [n_defs, B]
// with row stride prev_ds; lengths [B]; pairs [n_defs, P, 5], a = -1 pads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemPairs = 48 * 1024 / 12;  // 8-byte key + 4-byte value
constexpr int kRun = 4;  // consecutive positions per thread

__device__ __forceinline__ unsigned long long pair_key(int a, int b) {
  return ((unsigned long long)(unsigned)a << 32) | (unsigned)b;
}

__global__ void __launch_bounds__(kThreads)
table_tag_kernel(const int32_t* __restrict__ states, const int32_t* __restrict__ prev,
                 long long prev_ds, const int32_t* __restrict__ lengths,
                 const int32_t* __restrict__ pairs, int P, int32_t* __restrict__ ids,
                 int32_t* __restrict__ start, int32_t* __restrict__ endf, int B, int L,
                 int p0, int LS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = blockIdx.y;
  const int PS = P < kSmemPairs ? P : kSmemPairs;  // pairs staged in shared memory
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  int* vals = reinterpret_cast<int*>(keys + PS);
  const int32_t* pd = pairs + (size_t)d * P * 5;
  for (int i = threadIdx.x; i < PS; i += blockDim.x) {
    keys[i] = pair_key(pd[5 * i], pd[5 * i + 1]);
    vals[i] = (pd[5 * i + 2] << 2) | ((pd[5 * i + 3] != 0) << 1) | (pd[5 * i + 4] != 0);
  }
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int n_runs = (LS + kRun - 1) / kRun;
  if (i >= (size_t)n_runs * B) return;
  const int q = (int)(i / B);
  const int b = (int)(i - (size_t)q * B);
  const int len = lengths[b];
  const size_t o0 = ((size_t)d * L + p0 + q * kRun) * B + b;
  int nxt[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) nxt[r] = q * kRun + r < LS ? states[o0 + (size_t)r * B] : 0;
  int prv = q == 0 ? prev[(size_t)d * prev_ds + b] : states[o0 - B];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int p = q * kRun + r;
    if (p >= LS) break;
    int v = 0;
    if (p0 + p < len) {
      const unsigned long long key = pair_key(prv, nxt[r]);
      int k = 0;
      for (; k < PS; ++k)
        if (keys[k] == key) {
          v = vals[k];
          break;
        }
      if (k == PS)  // not among the staged pairs: the tail, in global memory
        for (; k < P; ++k) {
          const int32_t* e = pd + 5 * k;
          if (e[0] == prv && e[1] == nxt[r]) {
            v = (e[2] << 2) | ((e[3] != 0) << 1) | (e[4] != 0);
            break;
          }
        }
    }
    const size_t o = o0 + (size_t)r * B;
    ids[o] = v >> 2;
    start[o] = (v >> 1) & 1;
    endf[o] = v & 1;
    prv = nxt[r];
  }
}

}  // namespace

extern "C" int h2r_table_tag(const void* states, const void* prev, long long prev_ds,
                             const void* lengths, const void* pairs, int P, void* ids,
                             void* start, void* endf, int n_defs, int B, int L, int p0, int LS,
                             void* stream) {
  if (P < 0) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)((LS + kRun - 1) / kRun) * B;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), n_defs);
  const size_t smem = (size_t)(P < kSmemPairs ? P : kSmemPairs) * 12;
  table_tag_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)states, (const int32_t*)prev, prev_ds, (const int32_t*)lengths,
      (const int32_t*)pairs, P, (int32_t*)ids, (int32_t*)start, (int32_t*)endf, B, L, p0, LS);
  return (int)cudaGetLastError();
}
