// table_scan -- the table-driven DFA scan of the split matcher.
//
// Replaces the TPU kernels PallasMatcher._scan_kernel (B8,
// halo2_regex_tpu/ops/pallas_scan.py:756, pallas_call at :968) and
// _scan_kernel_seg (B11, :1039, pallas_call at :1195): per def d and string
// b, s = next[d][cls[d][c], s] for each byte c of the window [p0, p0 + LS),
// from the carried-in state init[d, b].  On the TPU the step is a one-hot
// MXU row select of a bf16 class table (with stride-2 pair tables, and
// lo/hi byte planes beyond 256 states), because Mosaic has no fast gather.
// Here the step is a gather.
//
// What bounds it on the H100: the chain of dependent shared-memory loads,
// one per byte, not bytes or operations.  A string's steps are serial, so
// one thread a string takes at least LS load latencies however many
// strings run beside it; with few strings (64 in the 1K-state stress
// model) that leaves the card nearly idle.  Two forms:
//
// Serial (one thread a string, the whole window), when the strings alone
// fill the card.  Everything but the chain is kept off it: the row
// addresses of 16 bytes come from one 16-byte load issued kAhead loads
// ahead, the next-state table sits in shared memory as uint16 (96 classes
// x 1008 states = 189 KiB for the stress model, under the 227 KiB
// opt-in) holding 2 * next, the next state's byte offset in a row, so a
// step is an add and one ld.shared, with no shift or conversion on the
// chain; states are stored time-major, so a warp's 32 stores at one
// position are one 128-byte line.
//
// Chunked (speculate, then repair), when they do not.  A random DFA
// resyncs: two walkers over the same bytes from different states meet
// after some hundreds or thousands of bytes (configs[3]'s: 726 at the
// median, 4920 at p99), and then agree for good.  The window is cut into
// chunks of C positions, one thread per (def, string, chunk), a warp on 32
// strings of one chunk (stores stay 128-byte lines):
//   S1, speculation: a chunk starts W positions before its first
//     position (at the window start if that comes first, which makes it
//     exact), from the string's entry state init[d, b], walks the warm-up
//     without storing, records the state it reaches as its guess g, then
//     walks and stores its chunk and records its end state e;
//   S2, repair: one thread per (def, string) walks its chunks in order.
//     Chunk 0 is exact.  Where chunk c - 1's true end differs from g[c],
//     chunk c is walked again from that end, overwriting the stored
//     states, until the walk meets the stored state: from there the stored
//     walk saw the same bytes from the same state, so it is right, and the
//     chunk's end is e[c].  A walk that reaches the chunk's end leaves a new
//     end, checked against g[c + 1].  A chunk whose guess matched is right
//     as stored.  The walk steps 16 positions while the next 16 bytes and
//     stored states load.  The overwritten positions are added to a
//     counter.
// This is exact for every DFA; one that never resyncs (a permutation per
// class) is repaired everywhere, serially, in S2.  S1's serial length is
// W + C steps in place of LS; a block stages the def's table once (with
// cp.async, from the uint16 copy the matcher keeps), and the wrapper sizes
// blocks so that the grid is about one block an SM.  A table too large for
// shared memory (or over 32768 states) is read from global memory through
// the read-only cache instead (smem_bytes = 0), in either form.
//
// Layouts (int32 unless stated): chars [B, L] uint8; cmap [n_defs, 256];
// next [n_defs, K, S] and next16, the same as uint16 2 * next; init [n_defs, B] with
// row stride init_ds; states [n_defs, L, B], rows p0..p0 + LS - 1 written;
// scratch [2, n_defs, NCH, B] (g, then e; NCH = ceil(LS / C)); repaired one
// unsigned 64-bit counter.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;        // serial form
constexpr int kRepairThreads = 128;  // S2: one thread a (def, string)
constexpr int kAhead = 4;            // 16-byte char loads in flight ahead of the chain
constexpr int kMaxDevices = 64;

struct Table {
  const int32_t* nx;  // [K, S] int32, global (kSmem false)
};

// One load of the shared-memory table at byte address addr.
__device__ __forceinline__ int lds16(unsigned addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// A walker's state: in shared memory the table holds 2 * next, so a state
// is carried as its byte offset in a row (2 * s) and a step is one add and
// one load, with no shift on the chain; from global memory, s itself.
template <bool kSmem>
__device__ __forceinline__ int enc(int s) {
  return kSmem ? 2 * s : s;
}
template <bool kSmem>
__device__ __forceinline__ int dec(int x) {
  return kSmem ? x >> 1 : x;
}

// off: row_off[byte] (the row's shared byte address, or class * S)
template <bool kSmem>
__device__ __forceinline__ int step(const Table& t, int off, int x) {
  if constexpr (kSmem) {
    return lds16((unsigned)(off + x));
  } else {
    return __ldg(t.nx + off + x);
  }
}

// Stages def d's row offsets and, for kSmem, its table of 2 * next as
// uint16 into shared memory: 16-byte cp.async copies where the copy is
// aligned, so all of them are in flight at once.  row_off[c] is the shared
// byte address of byte c's row (kSmem) or class(c) * S.
template <bool kSmem>
__device__ __forceinline__ void stage(const int32_t* __restrict__ cmap,
                                      const uint16_t* __restrict__ src, int n, int S, int d,
                                      int* row_off, uint16_t* tab) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(tab);
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    row_off[i] = kSmem ? (int)(base + 2u * (unsigned)(cmap[d * 256 + i] * S))
                       : cmap[d * 256 + i] * S;
  if (kSmem) {
    const int n16 = (n & 7) == 0 && ((uintptr_t)src & 15) == 0 ? n / 8 : 0;
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(tab + 8 * i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + 8 * i)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = 8 * n16 + threadIdx.x; i < n; i += blockDim.x) tab[i] = src[i];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
}

// Walks bytes [a, e) of one string's row from state s and returns the
// state after position e - 1; kStore writes each position's state to
// out[p * B] (out: the string's column of the def's plane).  Where vec,
// the 16-byte-aligned middle is read 16 bytes a load, kAhead loads ahead.
template <bool kSmem, bool kStore>
__device__ __forceinline__ int walk(const uint8_t* __restrict__ row, int a, int e, int s0,
                                    const int* row_off, const Table& t,
                                    int32_t* __restrict__ out, size_t B, bool vec) {
  int s = enc<kSmem>(s0);
  int p = a;
  if (vec) {
    const int m0 = (a + 15) & ~15, m1 = e & ~15;
    if (m0 < m1) {
      for (; p < m0; ++p) {
        s = step<kSmem>(t, row_off[row[p]], s);
        if (kStore) out[(size_t)p * B] = dec<kSmem>(s);
      }
      const uint4* row4 = reinterpret_cast<const uint4*>(row + m0);
      const int n16 = (m1 - m0) / 16;
      uint4 q[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) q[k] = __ldg(row4 + (k < n16 ? k : 0));
      for (int i = 0; i < n16; i += kAhead) {
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          if (i + k < n16) {
            const uint4 v = q[k];
            if (i + k + kAhead < n16) q[k] = __ldg(row4 + i + k + kAhead);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
            int off[16];
#pragma unroll
            for (int j = 0; j < 16; ++j) off[j] = row_off[(w[j >> 2] >> (8 * (j & 3))) & 0xFF];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              s = step<kSmem>(t, off[j], s);
              if (kStore) out[(size_t)(m0 + 16 * (i + k) + j) * B] = dec<kSmem>(s);
            }
          }
        }
      }
      p = m1;
    }
  }
  for (; p < e; ++p) {
    s = step<kSmem>(t, row_off[row[p]], s);
    if (kStore) out[(size_t)p * B] = dec<kSmem>(s);
  }
  return dec<kSmem>(s);
}

// The serial form: one thread a string over the whole window.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
table_scan_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ cmap,
                  const int32_t* __restrict__ next, const uint16_t* __restrict__ next16,
                  const int32_t* __restrict__ init, long long init_ds,
                  int32_t* __restrict__ states, int B, int L, int K, int S, int p0, int LS,
                  int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_off[256];
  const int d = blockIdx.y;
  const Table t{next + (size_t)d * K * S};
  stage<kSmem>(cmap, next16 + (size_t)d * K * S, K * S, S, d, row_off,
               reinterpret_cast<uint16_t*>(smem));
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  walk<kSmem, true>(chars + (size_t)b * L, p0, p0 + LS, init[(size_t)d * init_ds + b], row_off,
                    t, states + (size_t)d * L * B + b, B, vec);
}

// S1: one warp per (chunk, group of 32 strings) of def blockIdx.y;
// consecutive warps take consecutive string groups of one chunk.
template <bool kSmem>
__global__ void __launch_bounds__(1024)
table_scan_spec_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ cmap,
                       const int32_t* __restrict__ next, const uint16_t* __restrict__ next16,
                       const int32_t* __restrict__ init, long long init_ds,
                       int32_t* __restrict__ states, int32_t* __restrict__ scr, int n_defs,
                       int B, int L, int K, int S, int p0, int LS, int C, int W, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_off[256];
  const int d = blockIdx.y;
  const Table t{next + (size_t)d * K * S};
  stage<kSmem>(cmap, next16 + (size_t)d * K * S, K * S, S, d, row_off,
               reinterpret_cast<uint16_t*>(smem));
  const int n_ch = (LS + C - 1) / C, groups = (B + 31) / 32;
  const int item = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int c = item / groups;
  const int b = (item - c * groups) * 32 + (threadIdx.x & 31);
  if (c >= n_ch || b >= B) return;
  const int cs = p0 + c * C, ce = min(cs + C, p0 + LS);
  const int ws = max(p0, cs - W);  // the warm-up's first position
  const uint8_t* row = chars + (size_t)b * L;
  int32_t* out = states + (size_t)d * L * B + b;
  int s = walk<kSmem, false>(row, ws, cs, init[(size_t)d * init_ds + b], row_off, t, out, B,
                             vec);
  const size_t o = ((size_t)d * n_ch + c) * B + b;
  scr[o] = s;
  s = walk<kSmem, true>(row, cs, ce, s, row_off, t, out, B, vec);
  scr[(size_t)n_defs * n_ch * B + o] = s;
}

// The first chunk c >= c0 whose guess g[c] differs from chunk c - 1's stored
// end e[c - 1], or n_ch; 8 chunks' loads at a time, off the serial path.
__device__ __forceinline__ int next_mismatch(const int32_t* g, const int32_t* e, size_t B,
                                             int c0, int n_ch) {
  for (int c = c0; c < n_ch; c += 8) {
    int gv[8], ev[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = min(c + j, n_ch - 1);
      gv[j] = g[(size_t)k * B];
      ev[j] = e[(size_t)(k - 1) * B];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c + j < n_ch && gv[j] != ev[j]) return c + j;
  }
  return n_ch;
}

// The 16 bytes of a row from position p (zeros past e): one 16-byte load
// where aligned, else byte loads.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row, int p, int e, bool vec) {
  if (vec && (p & 15) == 0 && p + 16 <= e) return __ldg(reinterpret_cast<const uint4*>(row + p));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (p + j < e) w[j >> 2] |= (uint32_t)row[p + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The stored states of positions p .. p + 15 (clamped to e - 1).
__device__ __forceinline__ void load_states(const int32_t* __restrict__ out, int p, int e,
                                            size_t B, int* old) {
#pragma unroll
  for (int j = 0; j < 16; ++j) old[j] = out[(size_t)min(p + j, e - 1) * B];
}

// S2: one thread per (def, string).  A block in which no chunk's guess
// differs from its predecessor's stored end has nothing to repair and
// stages nothing.
template <bool kSmem>
__global__ void __launch_bounds__(kRepairThreads)
table_scan_repair_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ cmap,
                         const int32_t* __restrict__ next, const uint16_t* __restrict__ next16,
                         int32_t* __restrict__ states, const int32_t* __restrict__ scr,
                         unsigned long long* __restrict__ repaired, int n_defs, int B, int L,
                         int K, int S, int p0, int LS, int C, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_off[256];
  const int d = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  const int n_ch = (LS + C - 1) / C;
  const int32_t* g = scr + (size_t)d * n_ch * B + b;
  const int32_t* e = g + (size_t)n_defs * n_ch * B;
  int c = live ? next_mismatch(g, e, B, 1, n_ch) : n_ch;
  if (!__syncthreads_or(c < n_ch)) return;
  const Table t{next + (size_t)d * K * S};
  stage<kSmem>(cmap, next16 + (size_t)d * K * S, K * S, S, d, row_off,
               reinterpret_cast<uint16_t*>(smem));
  if (c >= n_ch) return;
  const uint8_t* row = chars + (size_t)b * L;
  int32_t* out = states + (size_t)d * L * B + b;
  unsigned long long fixed = 0;
  int end = e[(size_t)(c - 1) * B];  // chunk c - 1's true end
  while (c < n_ch) {
    bool met = end == g[(size_t)c * B];
    const int cs = p0 + c * C, ce = min(cs + C, p0 + LS);
    int s = enc<kSmem>(end);
    if (!met) {
      // 16 positions a group; the next group's bytes and stored states
      // are loaded while this group steps
      uint4 by_n = load16(row, cs, ce, vec);
      int old_n[16];
      load_states(out, cs, ce, B, old_n);
      for (int p = cs; p < ce && !met; p += 16) {
        const uint4 by = by_n;
        int old[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) old[j] = old_n[j];
        if (p + 16 < ce) {
          by_n = load16(row, p + 16, ce, vec);
          load_states(out, p + 16, ce, B, old_n);
        }
        const uint32_t w[4] = {by.x, by.y, by.z, by.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (!met && p + j < ce) {
            s = step<kSmem>(t, row_off[(w[j >> 2] >> (8 * (j & 3))) & 0xFF], s);
            if (dec<kSmem>(s) == old[j]) {
              met = true;
            } else {
              out[(size_t)(p + j) * B] = dec<kSmem>(s);
              ++fixed;
            }
          }
        }
      }
    }
    if (met) {  // the chunk's stored end is right: on to the next mismatch
      c = next_mismatch(g, e, B, c + 1, n_ch);
      if (c < n_ch) end = e[(size_t)(c - 1) * B];
    } else {
      end = dec<kSmem>(s);
      ++c;
    }
  }
  if (fixed) atomicAdd(repaired, fixed);
}

// Lets kernel fn (slot: one per instance) take the card's whole opt-in
// shared memory, once per device.
int allow_smem(const void* fn, int slot) {
  static int done[4][kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[slot][dev]) return 0;
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[slot][dev] = 1;
  return (int)err;
}

template <bool kSmem>
int launch(const uint8_t* chars, const int32_t* cmap, const int32_t* next,
           const uint16_t* next16, const int32_t* init, long long init_ds, int32_t* states,
           int32_t* scr, unsigned long long* repaired, int n_defs, int B, int L, int K, int S,
           int p0, int LS, int C, int W, int warps, int vec, int smem, cudaStream_t stream) {
  if (C <= 0) {
    if (kSmem) {
      const int err = allow_smem((const void*)table_scan_kernel<kSmem>, 0);
      if (err) return err;
    }
    const dim3 grid((B + kThreads - 1) / kThreads, n_defs);
    table_scan_kernel<kSmem><<<grid, kThreads, smem, stream>>>(
        chars, cmap, next, next16, init, init_ds, states, B, L, K, S, p0, LS, vec);
    return (int)cudaGetLastError();
  }
  if (kSmem) {
    int err = allow_smem((const void*)table_scan_spec_kernel<kSmem>, 1);
    if (!err) err = allow_smem((const void*)table_scan_repair_kernel<kSmem>, 2);
    if (err) return err;
  }
  const long long items = (long long)((LS + C - 1) / C) * ((B + 31) / 32);
  const dim3 grid1((unsigned)((items + warps - 1) / warps), n_defs);
  table_scan_spec_kernel<kSmem><<<grid1, 32 * warps, smem, stream>>>(
      chars, cmap, next, next16, init, init_ds, states, scr, n_defs, B, L, K, S, p0, LS, C, W,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((B + kRepairThreads - 1) / kRepairThreads, n_defs);
  table_scan_repair_kernel<kSmem><<<grid2, kRepairThreads, smem, stream>>>(
      chars, cmap, next, next16, states, scr, repaired, n_defs, B, L, K, S, p0, LS, C, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The card's per-block shared-memory opt-in limit, for the wrapper's choice
// of smem_bytes.
extern "C" int h2r_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// C = 0: the serial form (one launch); else the chunked form, S1 with
// warps warps a block, then S2 (two launches).  smem_bytes > 0: the uint16
// table next16 is staged in shared memory; 0: next is read from global
// memory.
extern "C" int h2r_table_scan(const void* chars, const void* cmap, const void* next,
                              const void* next16, const void* init, long long init_ds,
                              void* states, void* scratch, void* repaired, int n_defs, int B,
                              int L, int K, int S, int p0, int LS, int C, int W, int warps,
                              int vec, int smem_bytes, void* stream) {
  if (C > 0 && (warps < 1 || warps > 32 || W < 0)) return (int)cudaErrorInvalidValue;
  if (smem_bytes > 0)
    return launch<true>((const uint8_t*)chars, (const int32_t*)cmap, (const int32_t*)next,
                        (const uint16_t*)next16, (const int32_t*)init, init_ds,
                        (int32_t*)states, (int32_t*)scratch, (unsigned long long*)repaired,
                        n_defs, B, L, K, S, p0, LS, C, W, warps, vec, smem_bytes,
                        (cudaStream_t)stream);
  return launch<false>((const uint8_t*)chars, (const int32_t*)cmap, (const int32_t*)next,
                       (const uint16_t*)next16, (const int32_t*)init, init_ds, (int32_t*)states,
                       (int32_t*)scratch, (unsigned long long*)repaired, n_defs, B, L, K, S,
                       p0, LS, C, W, warps, vec, 0, (cudaStream_t)stream);
}
