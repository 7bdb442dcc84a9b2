// The slab kernel's table step, shared by slab_scan (probe_tpu9.cu: four
// picks and four stores a step, from state 0) and slab_anatomy
// (probe_tpu18.cu: N_OUT = 1, 2 or 4 picks and stores a step, from the
// model's first state).
//
// Per step: the class of the byte c = x[i, b] (classes[c], the clamped
// c taking the class of 0 or 255, as the probes' thresholds give it), then
// v_j = tk[class, j * S + s] for j < N_OUT and s = v_0.  Two forms:
//
// Chunked (slab_chunk_kernel, the default wherever S <= 32: every caller).
// Nothing in the function needs a string's steps to run on one SM; only a
// thread a string made them.  A block owns a tile of 32 strings x C
// positions (a template argument: 64, 128 or 512, ops/kernels.py
// `scan_chunk`'s); the grid fills the card.
//   1. Stage: the tile's bytes (whole 128-byte rows, every load issued
//      first), the table [K, 4S] and the class map into shared memory, then
//      the bytes as their row offsets, class * 4S.
//   2. Maps: each warp takes 32 / kChunkWarps strings of the tile and walks
//      the chunk with lane j starting from state j (lanes j >= S walk a copy
//      of state S - 1, so the warp stays uniform).  A step is one broadcast
//      load of the strings' row offsets and one dependent load a string,
//      tab[off + s_j]: the 32 lanes hit distinct banks or the same word.
//      Walks that meet stay together: once each string's walks hold at most
//      kNarrow states (a state bitmask, each 8 positions), the warp goes
//      narrow and walks only those, one load a position for all its
//      strings.  At each of the kChunkWarps sub-chunk starts a lane records
//      its state as one byte; its end state is the chunk's map m[j].
//   3. Start states: chunk 0 starts at `first`, chunk k + 1 at m_k(start_k).
//      A decoupled look-back (probe_lookback.cuh) with map composition as
//      its operator, (g o f)[j] = g[f[j]], one shuffle a composition, gives
//      each tile its strings' true start states.  A tile publishes its maps
//      at once (packed: four 8-byte words a string, eight 5-bit entries and
//      the call's epoch in each, one 32-byte sector a read), and at once its
//      end state wherever a string's map is constant (its walks all met: the
//      end state whatever the start); it reads back over its string group's
//      earlier tiles, kSlabWindow at a round, composing their maps, until it
//      meets a published end state, then publishes its other end states.
//      Nothing is guessed or repaired (the table scan's speculation,
//      table_scan.cu, repairs serially a DFA that never resyncs); a DFA
//      whose walks never meet keeps the maps wide and the look-backs long.
//   4. Replay: warp w takes sub-chunk w, a lane a string; its start state is
//      the recorded byte of lane `start`.  It walks the sub-chunk with the
//      N_OUT picks and stores them: a warp's store at one position is one
//      128-byte line.
// Its floor is bytes: one read of x and N_OUT writes.  The wide maps cost
// one shared-memory warp load a string a position whatever S is; narrow,
// a quarter of that, on one dependent chain a warp.
//
// Serial (slab_kernel, form "serial": S > 32, and the serial-step
// measurement of chip_smoke's [10]).  One thread owns one column (a
// string) and walks its rows in order, blocks of 32 threads; the table and
// class map sit in shared memory, the bytes come through probe_ring.cuh's
// ring eight rows a group.  The chain is one add and one shared-memory load
// a step; the other N_OUT - 1 loads and the N_OUT stores hang off it.
//
// Layouts: tk [K, 4S] int32; classes [256] int32; x [L, TB] int32 and
// each output [L, TB] int32 (L % 8 == 0 for the serial form).  Shared
// memory: the serial form (256 + 4 K S) * 4 bytes, the chunked form that
// plus C * 128 bytes of row offsets and 32 * 32 * kChunkWarps bytes of
// recorded states; past 48 KiB the launch opts in, up to the card's limit
// (probe_tpu6's k3, P4 [256, 128] with the identity class map, is
// slab_anatomy<2>).  The chunked form's scratch: the ticket, then a record
// a tile at a fixed stride (kRecordBytes): its 32 maps, four packed words
// of 8 bytes each, then its 32 end-state words of 4 bytes.  Whatever the
// grid, an address holds the same kind of word in every call (the wrapper
// keeps a scratch for this kernel alone), so a word that an earlier call
// left there carries that call's epoch in the same bits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_lookback.cuh"
#include "probe_ring.cuh"

namespace probe_slab {
namespace {  // internal linkage: each source that includes it has its own copy

constexpr int THREADS = 32;
constexpr int SLAB = 8;  // rows a group of the ring (the probes' SLAB)
constexpr int RING = 8;  // groups of eight rows (RING - 1 in flight)

constexpr int kChunkWarps = 8;  // warps a block; also the sub-chunks of a chunk
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kChunkStrings = 32 / kChunkWarps;  // strings a warp walks in the maps phase
constexpr int kChunkMaxS = 32;  // a warp holds every start state of a string
constexpr int kSlabWindow = 2;  // earlier tiles a look-back round reads (each string's at once)
constexpr int kNarrow = 32 / kChunkStrings;  // walks a string keeps once its walks have met
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMapBytes = 32 * 4 * 8;  // a tile's record: its 32 maps, then
constexpr int kRecordBytes = kMapBytes + 32 * 4;  // its 32 end-state words

// String str's four map words and its end-state word in tile t's record.
__device__ __forceinline__ unsigned long long* map_words(char* status, uint32_t t, int str) {
  return (unsigned long long*)(status + (size_t)t * kRecordBytes) + str * 4;
}
__device__ __forceinline__ uint32_t* end_word(char* status, uint32_t t, int str) {
  return (uint32_t*)(status + (size_t)t * kRecordBytes + kMapBytes) + str;
}

template <int N_OUT>
struct Outs {
  int32_t* o[N_OUT];
};

template <int N_OUT>
__global__ void __launch_bounds__(THREADS)
slab_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ classes,
            const int32_t* __restrict__ x, Outs<N_OUT> outs, int L, int TB, int K, int S,
            int first) {
  extern __shared__ int32_t smem[];
  int32_t* cmap = smem;        // [256]
  int32_t* tab = smem + 256;   // [K, 4S]
  __shared__ uint32_t ring[RING][SLAB][THREADS];  // slab p's bytes in slot p % RING
  const int row = 4 * S;
  for (int i = threadIdx.x; i < 256; i += THREADS) cmap[i] = classes[i];
  for (int i = threadIdx.x; i < K * row; i += THREADS) tab[i] = tk[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= TB) return;
  const int n_slabs = L / SLAB;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < n_slabs) {
#pragma unroll
      for (int j = 0; j < SLAB; ++j)
        probe_ring::copy4(&ring[p % RING][j][t], x + (size_t)(p * SLAB + j) * TB + b);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  int s = first;
#pragma unroll 1
  for (int p = 0; p < n_slabs; ++p) {
    fetch(p + RING - 1);  // into slot (p - 1) % RING, read at p - 1
    probe_ring::wait_oldest<RING>();
    const int32_t* base[SLAB];
#pragma unroll
    for (int j = 0; j < SLAB; ++j)
      base[j] = tab + cmap[min(max((int)ring[p % RING][j][t], 0), 255)] * row;
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      const int32_t* r = base[j] + s;
      int32_t v[N_OUT];
#pragma unroll
      for (int o = 0; o < N_OUT; ++o) v[o] = r[o * S];
      s = v[0];
      const size_t at = (size_t)(p * SLAB + j) * TB + b;
#pragma unroll
      for (int o = 0; o < N_OUT; ++o) outs.o[o][at] = v[o];
    }
  }
  probe_ring::wait_all();
}

// The row offsets of a warp's kChunkStrings strings at one position: one
// broadcast load (16 bytes for four strings).
__device__ __forceinline__ void row_offsets(const int32_t* p, int (&o)[kChunkStrings]) {
  if constexpr (kChunkStrings % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kChunkStrings; q += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + q);
      o[q] = v.x;
      o[q + 1] = v.y;
      o[q + 2] = v.z;
      o[q + 3] = v.w;
    }
  } else if constexpr (kChunkStrings == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = p[0];
  }
}

__host__ __device__ constexpr size_t chunk_smem(int K, int S, int C) {
  // table, class map, row offsets [C, 32]; the recorded states [32,
  // kChunkWarps, 32] as bytes
  return ((size_t)K * 4 * S + 256 + (size_t)C * 32) * sizeof(int32_t) + 32 * kChunkWarps * 32;
}

template <int N_OUT, int C>
__global__ void __launch_bounds__(kChunkThreads, (C <= 256 ? 32 : 16) / kChunkWarps)
slab_chunk_kernel(const int32_t* __restrict__ tk, const int32_t* __restrict__ classes,
                  const int32_t* __restrict__ x, Outs<N_OUT> outs, int L, int TB, int K, int S,
                  int first, uint32_t* ticket, char* status, uint32_t epoch) {
  constexpr int kRows = C / kChunkWarps;  // rows a warp stages; a sub-chunk's positions
  constexpr int kStep = kRows < 8 ? kRows : 8;  // positions between the maps' checks
  extern __shared__ __align__(16) int32_t chunk_stage[];
  const int row = 4 * S;
  int32_t* tab = chunk_stage;               // [K, 4S]
  int32_t* cmap = tab + K * row;            // [256]: each byte's row offset, class * 4S
  int32_t* off = cmap + 256;                // [C, 32]: the tile's row offsets
  uint8_t* bnd = (uint8_t*)(off + C * 32);  // [32 strings, kChunkWarps, 32 start states]
  __shared__ int start[32];  // the tile's start state a string
  const uint32_t t = probe_lookback::take_ticket(ticket);
  const int n_grp = (TB + 31) / 32;
  const int g = t % n_grp, r = t / n_grp, c0 = r * C;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = g * 32 + lane;
  const int str0 = w * kChunkStrings;

  // 1. the tile's bytes (all loads first), the table, the class map as row
  // offsets, then the bytes as row offsets
  int c[kRows];  // rows w, w + kChunkWarps, ... of string `lane`
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int p = c0 + w + u * kChunkWarps;
    c[u] = (p < L && b < TB) ? x[(size_t)p * TB + b] : 0;
  }
  for (int i = tid; i < K * row; i += kChunkThreads) tab[i] = tk[i];
  for (int i = tid; i < 256; i += kChunkThreads) cmap[i] = classes[i] * row;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    off[(w + u * kChunkWarps) * 32 + lane] = cmap[min(max(c[u], 0), 255)];
  __syncthreads();

  // 2. maps: lane j from state j, the strings [str0, str0 + kChunkStrings).
  // Walks that meet stay together, so once each string's 32 walks are at
  // most kNarrow states (checked each kStep positions), the warp goes narrow:
  // lane q kNarrow + d walks string q's d-th distinct state, and lane j of
  // string q reads its state from chain rho[q] of them; one load a position
  // for all the warp's strings.
  int s[kChunkStrings];
#pragma unroll
  for (int q = 0; q < kChunkStrings; ++q) s[q] = min(lane, S - 1);
  bool narrow = false;  // warp-uniform
  int rho[kChunkStrings];
  const int qn = lane / kNarrow;  // narrow: the string this lane walks
#pragma unroll 1
  for (int k = 0; k < kChunkWarps; ++k) {
    if (k) {
#pragma unroll
      for (int q = 0; q < kChunkStrings; ++q)
        bnd[((str0 + q) * kChunkWarps + k) * 32 + lane] =
            (uint8_t)(narrow ? __shfl_sync(kFull, s[0], q * kNarrow + rho[q]) : s[q]);
    }
    const int32_t* p = off + k * kRows * 32 + str0;
#pragma unroll 1
    for (int i = 0; i < kRows; i += kStep, p += kStep * 32) {
      if (narrow) {
#pragma unroll
        for (int u = 0; u < kStep; ++u) s[0] = tab[p[u * 32 + qn] + s[0]];
        continue;
      }
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        int o[kChunkStrings];
        row_offsets(p + u * 32, o);
#pragma unroll
        for (int q = 0; q < kChunkStrings; ++q) s[q] = tab[o[q] + s[q]];
      }
      unsigned seen[kChunkStrings];  // each string's states, a bit each
      bool fits = true;
#pragma unroll
      for (int q = 0; q < kChunkStrings; ++q) {
        seen[q] = __reduce_or_sync(kFull, 1u << s[q]);
        fits = fits && __popc(seen[q]) <= kNarrow;
      }
      if (fits) {  // lane (q, d) takes string q's d-th state; lane j of string q follows its own
        narrow = true;
        unsigned mine = seen[0];
#pragma unroll
        for (int q = 0; q < kChunkStrings; ++q) {
          rho[q] = __popc(seen[q] & ((1u << s[q]) - 1));
          mine = qn == q ? seen[q] : mine;
        }
        const int d = lane % kNarrow;
        s[0] = d < __popc(mine) ? (int)__fns(mine, 0, d + 1) : __ffs(mine) - 1;
      }
    }
  }
  if (narrow) {  // each lane's end state a string
    int v[kChunkStrings];
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) v[q] = __shfl_sync(kFull, s[0], q * kNarrow + rho[q]);
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) s[q] = v[q];
  }

  // 3. start states: publish the maps at once, look back, publish the end
  // states.  A map goes out packed, four words of eight 5-bit entries under
  // the epoch (bits 40-63), so a read of one is one 32-byte sector.  A round
  // reads, for each string not done, the end states and this lane's map
  // word of kSlabWindow earlier tiles at once, composes the maps nearest
  // first (acc = acc o m) up to the nearest end state written or the first
  // map not yet written, and applies the composition to that end state; a
  // round that finds nothing new waits a little before the next.
  if (r > 0) {
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) {
      unsigned long long word = (unsigned long long)epoch << 40;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        word |= (unsigned long long)__shfl_sync(kFull, s[q], (lane & ~7) + i) << (5 * i);
      if ((lane & 7) == 0)
        probe_lookback::st_relaxed(map_words(status, t, str0 + q) + (lane >> 3), word);
    }
  }
  // a constant map (the string's 32 walks met in the chunk) is the chunk's
  // end state whatever its start: published at once, it ends the next
  // tiles' look-backs here
  unsigned constant = 0;
#pragma unroll
  for (int q = 0; q < kChunkStrings; ++q) {
    if (r > 0 && __all_sync(kFull, s[q] == __shfl_sync(kFull, s[q], 0))) {
      constant |= 1u << q;
      if (lane == 0)
        probe_lookback::st_relaxed(end_word(status, t, str0 + q), (epoch << 5) | (uint32_t)s[q]);
    }
  }
  int st[kChunkStrings], acc[kChunkStrings], k[kChunkStrings];
#pragma unroll
  for (int q = 0; q < kChunkStrings; ++q) {
    st[q] = first;
    acc[q] = lane;
    k[q] = r == 0 ? -1 : (int)t - n_grp;  // the nearest tile still needed, -1 when done
  }
  for (;;) {
    bool all = true;
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) all = all && k[q] < 0;
    if (all) break;  // warp-uniform
    uint32_t e[kChunkStrings];  // every string's words in flight at once
    unsigned long long m[kChunkStrings][kSlabWindow];
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) {
      const int str = str0 + q;
      const int kl = k[q] - lane * n_grp;  // lane i < kSlabWindow: tile k - i n_grp's end state
      e[q] = k[q] >= 0 && lane < kSlabWindow && kl >= 0
                 ? probe_lookback::ld_relaxed(end_word(status, kl, str))
                 : 0u;
#pragma unroll
      for (int i = 0; i < kSlabWindow; ++i) {
        const int ki = k[q] - i * n_grp;
        m[q][i] = k[q] >= 0 && ki >= 0
                      ? probe_lookback::ld_relaxed(map_words(status, ki, str) + (lane >> 3))
                      : 0ull;
      }
    }
    bool moved = false;
#pragma unroll
    for (int q = 0; q < kChunkStrings; ++q) {
      if (k[q] < 0) continue;  // warp-uniform
      const unsigned ready = __ballot_sync(kFull, (e[q] >> 5) == epoch);
      const int d = ready ? __ffs(ready) - 1 : kSlabWindow;  // maps before the nearest end state
      int used = 0;
      bool stop = false;
#pragma unroll
      for (int i = 0; i < kSlabWindow; ++i) {
        const bool take = !stop && i < d && __all_sync(kFull, (m[q][i] >> 40) == epoch);
        if (take) {
          acc[q] = __shfl_sync(kFull, acc[q], (int)(m[q][i] >> (5 * (lane & 7))) & 31);
          used = i + 1;
        }
        stop = !take;
      }
      if (ready && used == d) {
        st[q] = __shfl_sync(kFull, acc[q], __shfl_sync(kFull, e[q], d) & 31);
        k[q] = -1;
      } else {
        k[q] -= used * n_grp;
      }
      moved = moved || used || ready;
    }
    if (!moved) __nanosleep(64);
  }
#pragma unroll
  for (int q = 0; q < kChunkStrings; ++q) {
    const int end = __shfl_sync(kFull, s[q], st[q]);
    if (lane == 0) {
      if (!(constant >> q & 1))
        probe_lookback::st_relaxed(end_word(status, t, str0 + q), (epoch << 5) | (uint32_t)end);
      start[str0 + q] = st[q];
    }
  }
  __syncthreads();

  // 4. replay: sub-chunk w of string `lane` from its recorded state
  const int s0 = start[lane];
  int v0 = w == 0 ? s0 : bnd[(lane * kChunkWarps + w) * 32 + s0];
  const int i_end = min(kRows * (w + 1), L - c0);
#pragma unroll 4
  for (int i = kRows * w; i < i_end; ++i) {
    const int32_t* rr = tab + off[i * 32 + lane] + v0;
    int32_t v[N_OUT];
#pragma unroll
    for (int o = 0; o < N_OUT; ++o) v[o] = rr[o * S];
    v0 = v[0];
    if (b < TB) {
      const size_t at = (size_t)(c0 + i) * TB + b;
#pragma unroll
      for (int o = 0; o < N_OUT; ++o) outs.o[o][at] = v[o];
    }
  }
}

// Past the 48 KiB default: opt ``kern`` in to ``smem`` bytes of dynamic
// shared memory, or a cudaError code where the card's opt-in (less
// ``fixed`` bytes of static shared memory) is smaller.
template <typename Kern>
int opt_in(Kern kern, size_t smem, size_t fixed) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem + fixed > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch the slab kernel on outs[0..N_OUT); a cudaError code.  ``chunk``:
// 0 for the serial form, else the chunked form's C (64, 128 or 512; S <=
// kChunkMaxS) with ``scratch`` (the ticket, then a record of kRecordBytes
// a tile) and the call's ``epoch`` (under 2^24).
template <int N_OUT, int C>
int launch_chunked(const void* tk, const void* classes, const void* x, Outs<N_OUT> o, int L,
                   int TB, int K, int S, int first, void* scratch, unsigned epoch,
                   cudaStream_t st) {
  const int n_blk = (TB + 31) / 32 * ((L + C - 1) / C);
  if (n_blk == 0) return (int)cudaSuccess;
  const size_t smem = chunk_smem(K, S, C);
  const int e = opt_in(slab_chunk_kernel<N_OUT, C>, smem, sizeof(int) * 33);
  if (e) return e;
  slab_chunk_kernel<N_OUT, C><<<n_blk, kChunkThreads, smem, st>>>(
      (const int32_t*)tk, (const int32_t*)classes, (const int32_t*)x, o, L, TB, K, S, first,
      (uint32_t*)scratch, (char*)scratch + probe_lookback::kTicketBytes, epoch);
  return (int)cudaGetLastError();
}

template <int N_OUT>
int launch(const void* tk, const void* classes, const void* x, void* const* outs, int L,
           int TB, int K, int S, int first, int chunk, void* scratch, unsigned epoch,
           cudaStream_t st) {
  Outs<N_OUT> o;
  for (int j = 0; j < N_OUT; ++j) o.o[j] = (int32_t*)outs[j];
  if (chunk == 0) {
    if (L % SLAB) return (int)cudaErrorInvalidValue;
    const size_t smem = (256 + (size_t)K * 4 * S) * sizeof(int32_t);
    const int e = opt_in(slab_kernel<N_OUT>, smem, sizeof(uint32_t) * RING * SLAB * THREADS);
    if (e) return e;
    slab_kernel<N_OUT><<<(TB + THREADS - 1) / THREADS, THREADS, smem, st>>>(
        (const int32_t*)tk, (const int32_t*)classes, (const int32_t*)x, o, L, TB, K, S, first);
    return (int)cudaGetLastError();
  }
  if (S > kChunkMaxS || scratch == nullptr || epoch == 0 || epoch >= (1u << 24))
    return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 64: return launch_chunked<N_OUT, 64>(tk, classes, x, o, L, TB, K, S, first, scratch, epoch, st);
    case 128: return launch_chunked<N_OUT, 128>(tk, classes, x, o, L, TB, K, S, first, scratch, epoch, st);
    case 512: return launch_chunked<N_OUT, 512>(tk, classes, x, o, L, TB, K, S, first, scratch, epoch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace probe_slab
