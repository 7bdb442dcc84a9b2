// dfa_wide -- the configs[3] table-step bisects of tools/ as one H100
// kernel: the DFA step s <- T[c, s] on a table of up to 256 classes x 1024
// states, with the probes' options.  It replaces probe_tpu6.py's k2 (:72,
// pallas_call at :98), probe_tpu7.py's scan_kernel (:28, :80), probe_tpu28's
// v1 and v2 (:66, :92, through try_variant :32, :40), probe_tpu30's w1 and
// w2 (:65, :76; :99, :104; w3 chains w2, :128), probe_tpu31's build (:24,
// :56) and probe_tpu32's build (:26, :82 and :115).  P7's dfa_step
// (probe_dfa_step.cu) keeps the [256, 128] probes.
//
// The function, on the table as the probes' bodies read it (bf16, so an
// f32 value past 256 may round): T [K, W] bf16 of integer values, W = S or,
// with HILO, 2S (lo columns [0, S), hi columns [S, 2S)); chars [L, TB] int32
// time-major; per string from its entry state entry[b]:
//   class c' = CMOD ? c mod K (floor) : c
//   v = T[c', s] (+ 256 T[c', S + s] with HILO), then v mod S with SMOD,
//   and v = 0 where c' lies outside [0, K) or s outside [0, S) (the probes'
//   one-hot and select then have no term),
// one state written a position, out [L, TB] int32.  The last row is the
// exit state: a second launch entered there continues the scan (w3).
// COUNT (probe_tpu28's v1) has no chain: out[t, b] = T[c', 0] + t +
// entry[b], position-parallel.
//
// The forms:
//   LOOKUP:     a thread a string.  The decoded next states as uint16 in
//               shared memory (K S 2 bytes: 193.5 KiB at 96 x 1008, within
//               the 227 KiB opt-in beside four warps' rings), staged by
//               eight warps with eight loads in flight each, one LDS a
//               step; or, where they do not fit ((128, 1008) and (128,
//               1024) need 252-256 KiB), read from the bf16 table in global
//               memory, which stays in L2: one or two loads a step, decoded
//               in registers.  A group's eight class rows are read before
//               its chain, which is then a compare, an add and the load a
//               step, with no branch (the table's place is a template
//               parameter); each lane fetches and stores its own string's
//               words, so no step waits on another lane.
//   ONEHOT_MMA: the probes' method at its full cost: a warp takes 16
//               strings, forms the one-hot of their 16 classes as bf16 A
//               fragments, and multiplies it by all W columns of T
//               (mma.sync.m16n8k16, f32 accumulators): ceil(K / 16) x
//               ceil(W / 8) products a step, 1512 at 96 x 2016.  Each row
//               then keeps column s (and S + s) by a masked sum over its
//               accumulators and the 4 lanes of its row.  The B fragments
//               are the same for every string, and at 96 x 2016 (387 KiB
//               of bf16) they do not fit a block's shared memory; rather
//               than split W across a cluster (a cluster barrier and a
//               remote exchange of the picks every step), each warp
//               streams them from L2 in fragment order (the wrapper's
//               b_fragments), four n tiles' loads issued at once, one warp
//               a block so that each block's SM brings its own L2
//               bandwidth.  The products are exact: one nonzero term a
//               sum, integer values under 2^16.
// What bounds it: LOOKUP the chain of dependent loads a step (bytes only at
// a large batch: the chars in, the states out); ONEHOT_MMA the fragment
// stream's L2 latency (a group of four n tiles' loads, then their
// products) and the products' dependent accumulations, neither on the
// state's chain but all of it each step.  The lookup's chars come through a ring of cp.async copies
// (probe_ring.cuh), 8 positions a group, RING - 1 groups ahead; the product
// form reads its chars a group ahead and stages its 16 strings' states a
// group at a time, stored with the strings across lanes.  (The first
// designs, one block shape for both forms with the lookup's chars and
// states through a warp-shared ring, its table staged by two warps one
// load at a time, and the product's fragments loaded from L2 into
// registers as each product needed them, ran configs[3]'s step at 132 ns
// a position by lookup, at 75 us by the product: per-group bookkeeping,
// staging and L2 latency, not the chain or the tensor cores.  Streaming
// the fragments through a cp.async ring in shared memory, 8 bytes a lane
// a copy, was slower still: 81-158 us.)

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace {

constexpr int GROUP = 8;  // positions a ring group
constexpr int RING = 8;   // groups (RING - 1 in flight)
constexpr uint32_t BF16_ONE = 0x3F80u;
constexpr int MAX_KT = 16;  // k tiles of 16 classes: K <= 256
constexpr int NTU = 4;      // n tiles the product loads at once

enum Form { LOOKUP = 0, ONEHOT_MMA = 1, COUNT = 2 };

struct Step {
  int K, S, W;  // classes, states, table columns (S, or 2S with hilo)
  int hilo, cmod, smod;
};

constexpr int LOOKUP_WARPS = 8;  // a lookup block: all stage the table
constexpr int SCAN_WARPS = 4;    // then these scan, 32 strings each
constexpr int STAGE = 8;         // table entries a staging thread loads at once
// the lookup's shared memory past its table: the scanning warps' rings
constexpr int LOOKUP_RING_BYTES = SCAN_WARPS * RING * GROUP * 32 * 4;

__device__ __forceinline__ int class_of(int c, const Step& p) {
  if (!p.cmod) return c;
  const int r = c % p.K;
  return r < 0 ? r + p.K : r;
}

__device__ __forceinline__ int bf16_value(uint16_t h) {
  return (int)__uint_as_float((uint32_t)h << 16);
}

// the next state at row offset rw = c W (c < K) and state s < S of the
// bf16 table
__device__ __forceinline__ int decode(const uint16_t* __restrict__ T, int rw, int s,
                                      const Step& p) {
  const uint16_t* row = T + rw;
  int v = bf16_value(__ldg(row + s));
  if (p.hilo) v += 256 * bf16_value(__ldg(row + p.S + s));
  return p.smod ? v % p.S : v;
}

__device__ __forceinline__ uint32_t onehot2(int c, int k) {
  return (c == k ? BF16_ONE : 0u) | (c == k + 1 ? BF16_ONE << 16 : 0u);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the column pick of one row: lo at column tl, hi at column th (-1: none)
__device__ __forceinline__ void pick(float& lo, float& hi, int n, float x0, float x1, int tl,
                                     int th) {
  lo += (n == tl ? x0 : 0.f) + (n + 1 == tl ? x1 : 0.f);
  hi += (n == th ? x0 : 0.f) + (n + 1 == th ? x1 : 0.f);
}

// LOOKUP: a block of LOOKUP_WARPS warps stages the decoded table (SMEM),
// then its first SCAN_WARPS warps scan, a thread a string.  Each thread
// copies its own string's chars of the next RING - 1 groups into its own
// ring slots (no other lane reads them), and stores each state straight
// out (the warp's 32 strings are adjacent words).
template <bool SMEM>
__global__ void __launch_bounds__(LOOKUP_WARPS * 32)
wide_lookup_kernel(const uint16_t* __restrict__ T, const int32_t* __restrict__ chars,
                   const int32_t* __restrict__ entry, int32_t* __restrict__ out, int TB, int L,
                   Step p, int tab_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = (uint16_t*)smem;
  if constexpr (SMEM) {  // STAGE rows' loads in flight a thread
    const int n = p.K * p.S, step = LOOKUP_WARPS * 32;
    for (int q0 = threadIdx.x; q0 < n; q0 += STAGE * step) {
      int v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * step;
        v[u] = q < n ? decode(T, q / p.S * p.W, q % p.S, p) : 0;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (q0 + u * step < n) tab[q0 + u * step] = (uint16_t)v[u];
    }
    __syncthreads();
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = (blockIdx.x * SCAN_WARPS + w) * 32 + lane;
  if (w >= SCAN_WARPS || b - lane >= TB) return;
  // the lane's [RING][GROUP] words, the warp's lanes side by side
  uint32_t* ring = (uint32_t*)(smem + tab_bytes) + w * RING * GROUP * 32 + lane;
  const bool live = b < TB;
  const int n_groups = (L + GROUP - 1) / GROUP;
  auto fetch = [&](int g) {  // group g's chars into slot g % RING; an empty group past L
    if (live && g < n_groups) {
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
        if (g * GROUP + j < L)
          probe_ring::copy4(ring + ((g % RING) * GROUP + j) * 32,
                            chars + (size_t)(g * GROUP + j) * TB + b);
    }
    probe_ring::commit();
  };
  for (int g = 0; g < RING - 1; ++g) fetch(g);
  int s = live ? entry[b] : 0;
#pragma unroll 1
  for (int g = 0; g < n_groups; ++g) {
    fetch(g + RING - 1);  // into slot (g - 1) % RING, read at g - 1
    probe_ring::wait_oldest<RING>();
    // the group's rows first (off the chain): c S in the shared table, c W
    // in the global one, or -1 for a class past K
    int row[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int c = class_of((int)ring[((g % RING) * GROUP + j) * 32], p);
      row[j] = (unsigned)c < (unsigned)p.K ? c * (SMEM ? p.S : p.W) : -1;
    }
    // the chain: a compare, an add and one load a step
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const bool ok = row[j] >= 0 && (unsigned)s < (unsigned)p.S;
      int v;
      if constexpr (SMEM)
        v = tab[ok ? row[j] + s : 0];
      else
        v = ok ? decode(T, row[j], s, p) : 0;
      s = ok ? v : 0;
      if (live && g * GROUP + j < L) out[(size_t)(g * GROUP + j) * TB + b] = s;
    }
  }
  probe_ring::wait_all();
}

// ONEHOT_MMA: a warp a block and 16 strings; frags: the B fragments
// [ceil(W / 8)][Kt = ceil(K / 16)][32 lanes] (uint2: the bf16 pairs of rows
// k, k + 1 and k + 8, k + 9 of column n), zero past K and W.  Each lane
// loads its own 8 bytes of the fragments of NTU n tiles at once (up to NTU
// x 16 loads in flight), then runs their products: even and odd k tiles
// into two accumulators (two chains of dependent products, not one; a sum
// with a zero is exact), the A fragment of k tile kt made from the step's
// two classes as it is needed (it is nonzero in one k tile only), and each
// n tile's pick.  The chars are read a group ahead into registers and
// staged for the group; the states are staged a group at a time.
__global__ void __launch_bounds__(32)
wide_mma_kernel(const uint2* __restrict__ frags, const int32_t* __restrict__ chars,
                const int32_t* __restrict__ entry, int32_t* __restrict__ out, int TB, int L,
                Step p) {
  constexpr int STR = 16, ITEMS = GROUP * STR / 32;  // a lane's chars a group
  __shared__ int32_t cbuf[GROUP * STR];             // [GROUP][STR] the group's chars
  __shared__ int32_t obuf[GROUP * STR];             // [GROUP][STR] its states
  const int lane = threadIdx.x, gr = lane >> 2, tig = lane & 3;
  const int b0 = blockIdx.x * STR;
  const int Kt = (p.K + 15) / 16, Nt = (p.W + 7) / 8;  // Kt <= MAX_KT
  const uint2* fr = frags + lane;
  const int n_groups = (L + GROUP - 1) / GROUP;
  int nxt[ITEMS];  // the next group's chars, a lane's items q = lane + 32 u
  auto load_chars = [&](int g) {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int q = lane + 32 * u, b = b0 + q % STR, i = g * GROUP + q / STR;
      nxt[u] = g < n_groups && b < TB && i < L ? chars[(size_t)i * TB + b] : 0;
    }
  };
  load_chars(0);
  int s_lo = b0 + gr < TB ? entry[b0 + gr] : 0;  // rows gr and gr + 8
  int s_hi = b0 + gr + 8 < TB ? entry[b0 + gr + 8] : 0;
#pragma unroll 1
  for (int g = 0; g < n_groups; ++g) {
    __syncwarp();  // the last group's chars and states are read
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) cbuf[lane + 32 * u] = nxt[u];
    __syncwarp();
    load_chars(g + 1);  // lands while this group's steps run
#pragma unroll 1
    for (int j = 0; j < GROUP; ++j) {
      // a class past K matches only zero rows of the fragments, or none
      const int c0 = class_of(cbuf[j * STR + gr], p);
      const int c1 = class_of(cbuf[j * STR + gr + 8], p);
      const int tl0 = (unsigned)s_lo < (unsigned)p.S ? s_lo : -1;
      const int tl1 = (unsigned)s_hi < (unsigned)p.S ? s_hi : -1;
      const int th0 = p.hilo && tl0 >= 0 ? p.S + tl0 : -1;
      const int th1 = p.hilo && tl1 >= 0 ? p.S + tl1 : -1;
      // the A fragments: row gr's class c0 in k tile c0 >> 4 (registers a0,
      // a2 of the lanes with tig = (c0 & 7) >> 1), row gr + 8's c1 likewise
      const int d0 = c0 - tig * 2, d1 = c1 - tig * 2;
      const uint32_t v00 = onehot2(d0 & 15, 0), v02 = onehot2(d0 & 15, 8);
      const uint32_t v11 = onehot2(d1 & 15, 0), v13 = onehot2(d1 & 15, 8);
      const int k0 = d0 >= 0 ? d0 >> 4 : -1, k1 = d1 >= 0 ? d1 >> 4 : -1;
      float lo0 = 0.f, hi0 = 0.f, lo1 = 0.f, hi1 = 0.f;
#pragma unroll 1
      for (int nt0 = 0; nt0 < Nt; nt0 += NTU) {
        uint2 bf[NTU][MAX_KT];  // the NTU n tiles' fragments, all loads issued first
#pragma unroll
        for (int u = 0; u < NTU; ++u) {
#pragma unroll
          for (int kt = 0; kt < MAX_KT; ++kt)
            bf[u][kt] = kt < Kt && nt0 + u < Nt ? __ldg(fr + ((size_t)(nt0 + u) * Kt + kt) * 32)
                                                : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < NTU; ++u) {
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kt = 0; kt < MAX_KT; ++kt) {
            if (kt < Kt)
              mma_bf16(acc[kt & 1], kt == k0 ? v00 : 0u, kt == k1 ? v11 : 0u,
                       kt == k0 ? v02 : 0u, kt == k1 ? v13 : 0u, bf[u][kt].x, bf[u][kt].y);
          }
          const int n = (nt0 + u) * 8 + tig * 2;
          pick(lo0, hi0, n, acc[0][0] + acc[1][0], acc[0][1] + acc[1][1], tl0, th0);
          pick(lo1, hi1, n, acc[0][2] + acc[1][2], acc[0][3] + acc[1][3], tl1, th1);
        }
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        lo0 += __shfl_xor_sync(0xffffffffu, lo0, x);
        hi0 += __shfl_xor_sync(0xffffffffu, hi0, x);
        lo1 += __shfl_xor_sync(0xffffffffu, lo1, x);
        hi1 += __shfl_xor_sync(0xffffffffu, hi1, x);
      }
      s_lo = (int)lo0 + 256 * (int)hi0;
      s_hi = (int)lo1 + 256 * (int)hi1;
      if (p.smod) {
        s_lo %= p.S;
        s_hi %= p.S;
      }
      if (tig == 0) {
        obuf[j * STR + gr] = s_lo;
        obuf[j * STR + gr + 8] = s_hi;
      }
    }
    __syncwarp();  // the group's states are staged
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int q = lane + 32 * u, b = b0 + q % STR, i = g * GROUP + q / STR;
      if (b < TB && i < L) out[(size_t)i * TB + b] = obuf[q];
    }
  }
}

constexpr int COUNT_THREADS = 256;

__global__ void __launch_bounds__(COUNT_THREADS)
count_kernel(const uint16_t* __restrict__ T, const int32_t* __restrict__ chars,
             const int32_t* __restrict__ entry, int32_t* __restrict__ out, int TB, int L,
             Step p) {
  const long long n = (long long)L * TB;
  for (long long q = (long long)blockIdx.x * COUNT_THREADS + threadIdx.x; q < n;
       q += (long long)gridDim.x * COUNT_THREADS) {
    const int i = (int)(q / TB), b = (int)(q % TB);
    const int c = class_of(chars[q], p);
    const int v = (unsigned)c < (unsigned)p.K ? bf16_value(__ldg(T + (size_t)c * p.W)) : 0;
    out[q] = (int32_t)((uint32_t)v + (uint32_t)i + (uint32_t)entry[b]);
  }
}

template <bool SMEM>
int launch_lookup(const void* T, const void* chars, const void* entry, void* out, int TB, int L,
                  const Step& p, cudaStream_t st) {
  const int tab_bytes = SMEM ? (p.K * p.S * 2 + 15) / 16 * 16 : 0;
  const size_t smem = (size_t)tab_bytes + LOOKUP_RING_BYTES;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  auto kern = wide_lookup_kernel<SMEM>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = SCAN_WARPS * 32;
  kern<<<(TB + per_block - 1) / per_block, LOOKUP_WARPS * 32, smem, st>>>(
      (const uint16_t*)T, (const int32_t*)chars, (const int32_t*)entry, (int32_t*)out, TB, L, p,
      tab_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// form 0 LOOKUP (in_smem: the decoded table in shared memory), 1
// ONEHOT_MMA (frags required), 2 COUNT; T [K, W] bf16 bits, W = S or 2S
// (hilo); chars [L, TB], entry [TB], out [L, TB] int32
extern "C" int h2r_dfa_wide(const void* T, const void* frags, const void* chars,
                            const void* entry, void* out, int TB, int L, int K, int W, int hilo,
                            int cmod, int smod, int form, int in_smem, void* stream) {
  if (TB <= 0 || L <= 0 || K < 1 || K > 256 || W < 1 || (hilo && W % 2) ||
      (form == ONEHOT_MMA && frags == nullptr) || (in_smem && form != LOOKUP))
    return (int)cudaErrorInvalidValue;
  const Step p{K, hilo ? W / 2 : W, W, hilo != 0, cmod != 0, smod != 0};
  if (p.S > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == LOOKUP && in_smem) return launch_lookup<true>(T, chars, entry, out, TB, L, p, st);
  if (form == LOOKUP) return launch_lookup<false>(T, chars, entry, out, TB, L, p, st);
  if (form == ONEHOT_MMA) {
    wide_mma_kernel<<<(TB + 15) / 16, 32, 0, st>>>(
        (const uint2*)frags, (const int32_t*)chars, (const int32_t*)entry, (int32_t*)out, TB, L,
        p);
    return (int)cudaGetLastError();
  }
  if (form == COUNT) {
    const long long n = (long long)L * TB;
    const long long need = (n + COUNT_THREADS - 1) / COUNT_THREADS;
    const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
    count_kernel<<<blocks, COUNT_THREADS, 0, st>>>((const uint16_t*)T, (const int32_t*)chars,
                                                   (const int32_t*)entry, (int32_t*)out, TB, L,
                                                   p);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
