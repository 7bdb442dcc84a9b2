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
// LOOKUP: a thread walks a string, one dependent shared-memory load a
// step.  The table is decoded once a block into shared memory as uint16
// [K + 1][S + 1] byte offsets 2 min(next, S): column S and row K hold 0 (a
// state or class out of range gives state 0), so the chain is an add and
// one LDS, with no compare; a next state past S (no SMOD) is walked as S
// and written as itself, decoded again from T off the chain.  Where it
// does not fit beside the rings ((128, 1008) and (128, 1024) need 255-258
// KiB), the walk decodes from the bf16 table in global memory (L2): one or
// two loads, a compare and the decode a step.  A group's rows are read
// from its chars while the group before walks.  What bounds it: the chain
// (the lone LDS chain: 48.5 cycles a step; about 66 at configs[3], its
// random rows' bank conflicts and each group's copies and warp barriers
// beside it), so a string's L steps take L chain steps however many
// strings run beside it.  configs[3]'s 64
// strings fill one SM of 132, so where the strings are fewer than four
// warps an SM and L > 2 (W + C) (kernels.table_scan_form, B8's rule, C =
// 512, W = 8192) the walk is chunked as B8's scan is (table_scan.cu):
//   S1: a thread a (string, chunk of C positions), a warp 32 strings of
//       one chunk; it starts W positions before the chunk (at position 0
//       from the entry state if that comes first, which makes it exact),
//       walks the warm-up without storing, records the state it reached
//       (its guess g), then walks and stores its chunk and records its end
//       e: W + C chain steps in place of L, over about one block an SM;
//   S2: a thread a string walks its chunks in order; where chunk c - 1's
//       true end differs from g[c], it walks chunk c again from that end,
//       overwriting, until it meets the stored state (from there the
//       stored walk is right); a device counter adds the overwritten
//       positions.  A random table resyncs within the warm-up, so nothing
//       is repaired; a permutation table is repaired everywhere.
// Guesses and ends are compared as states clamped to S (every state past
// S walks on alike); the repair meets on the written states themselves.
// The chars come through the warp's ring of cp.async copies (16 bytes,
// four strings a copy, where TB allows), 16 positions a group, 7 groups
// ahead (3 where the shared memory past the table holds no more); each
// lane stores its own string's states (a warp's 32 are one line).
//
// ONEHOT_MMA: the probes' method: each step the one-hot of the strings'
// classes times all W columns of T on the tensor cores, then the pick of
// column s (and S + s).  A warpgroup takes 64 strings (wgmma's m64) and
// builds their one-hot in registers by HSET2 compares (a class less (2 q,
// 2 q + 1) against (16 kt, 16 kt) and (16 kt + 8, 16 kt + 8), as
// probe_dfa_step.cu does) as the register A operand of wgmma m64n128k16
// (f16, f32 sums: one nonzero term a sum, integer values under 2^16, so
// exact; T's bf16 integers are f16 integers).  T's columns are split over
// a cluster of R = ceil(W / 128) blocks (up to 16, non-portable): rank r
// holds columns [r NR, (r + 1) NR), NR = ceil(W / R) rounded up to 8, in
// shared memory for the whole scan (K-major under the 128-byte swizzle,
// from the wrapper's b_fragments), so a step is ceil(K / 16) wgmma a rank
// (6 at 96 x 2016: 16 ranks of 128 columns).  The products do not depend
// on the state: step t + 1's are issued before the exchange of step t's
// picks, and run under it.  Each step the rank holding column s of a
// string picks it from its accumulators (selects in registers, in
// uniform code), and each rank sends every rank its word of every string
// (lo + 2^16 hi, 0 where another rank holds the column) by st.async, two
// strings' pairs of rows in one 16-byte store, whose bytes the receiving
// warp's mbarrier counts; each warp then sums the ranks' words of its 16
// rows into lo + 256 hi (mod S).  Step t's words go to slot t mod 2: a
// rank that has every rank's words of step t knows that every rank has
// read step t - 1's, so no slot is overwritten before it is read, with no
// cluster barrier.  What bounds it: each step's exchange, a round of
// remote stores from every rank to every rank (at configs[3] 0.71 us of
// the 0.97 us a step: without it a step takes 0.26), not the products (6
// x ~69 cycles at 96 x 2016) nor the picks; 16 SMs' tensor rate could do
// no better than 1.64 x 132 / 16 = 13.5 ms at configs[3].  The round costs
// about as much however it is made (weak 16-byte remote stores of tagged
// words, polled, are within a few %); storing each word alone into every
// rank behind a cluster barrier costs more (the barrier's release is a
// GPU-wide memory barrier), and so does one bulk copy a rank (a proxy
// fence and a block barrier before it).  A single warp streaming all of
// T's fragments from L2 every step (mma.sync, one warp an SM, no split)
// takes 66 us a step: the exchange costs far less than those reads.  The
// chars come a group of 8 steps ahead through a ring of cp.async copies;
// the states are staged a group at a time and stored by each rank in
// turn, 64 strings' words a position.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "probe_ring.cuh"

namespace {

constexpr int GROUP = 8;   // positions a group of the product's ring
constexpr int LGROUP = 16;  // positions a group of the lookup's ring
constexpr int RING = 8;     // the lookup's groups a warp (RING - 1 in flight), or 4 where
                            // the shared memory past the table holds no more
constexpr int MAX_W = 2048;

enum Form { LOOKUP = 0, ONEHOT_MMA = 1, COUNT = 2 };

struct Step {
  int K, S, W;  // classes, states, table columns (S, or 2S with hilo)
  int hilo, cmod, smod;
};

constexpr int LOOKUP_WARPS = 8;  // a lookup block: all stage the table
constexpr int SCAN_WARPS = 4;    // then up to these walk, 32 strings each
constexpr int STAGE = 8;         // table units a staging thread loads at once
constexpr int REPAIR_THREADS = LOOKUP_WARPS * 32;  // S2: a thread a string
// a lookup ring group in shared memory past the table: [LGROUP][32 strings]
constexpr int LGROUP_BYTES = LGROUP * 32 * 4;

// the product form's geometry
constexpr int kMmaN = 128;       // a rank's n tile: wgmma m64n128k16
constexpr int kMaxCluster = 16;  // ranks over T's columns (past the portable 8: opted in)
constexpr int kTiles = (MAX_W + kMaxCluster * kMmaN - 1) / (kMaxCluster * kMmaN);  // n tiles a rank
constexpr int kStrings = 64;     // a cluster's: one warpgroup's m64
constexpr int kMmaRing = 4;      // char groups (kMmaRing - 2 ahead of the one read)
constexpr int kObuf = 3;         // groups of states staged (stored two groups late)
constexpr int kSlots = 2;        // exchange slots: step t's words in slot t % kSlots

template <bool CMOD>
__device__ __forceinline__ int class_in(int c, const Step& p) {
  if (!CMOD) return c;
  const int r = c % p.K;
  return r < 0 ? r + p.K : r;
}

__device__ __forceinline__ int class_of(int c, const Step& p) {
  return p.cmod ? class_in<true>(c, p) : class_in<false>(c, p);
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

// the uint16 at shared address row + x: one add and one load (as asm, so
// that the compiler does not fold the row's address into the chain)
__device__ __forceinline__ int lds16_at(uint32_t row, uint32_t x) {
  unsigned short v;
  asm volatile("{\n .reg .u32 a;\n add.u32 a, %1, %2;\n ld.shared.u16 %0, [a];\n}\n"
               : "=h"(v)
               : "r"(row), "r"(x));
  return v;
}

// ------------------------------------------------------------------ LOOKUP

// A walk's state.  SMEM: the byte offset x = 2 min(s, S) in a row of the
// decoded table at shared address `tab` (a row's address: tab + 2 (S + 1)
// c); else the state s, decoded from T in global memory.
template <bool SMEM>
struct Walker {
  const uint16_t* T;
  uint32_t tab;
  Step p;
  int x;

  __device__ __forceinline__ void enter(int s) {
    x = SMEM ? ((unsigned)s < (unsigned)p.S ? 2 * s : 2 * p.S) : s;
  }
  // a char's row: its shared address in the decoded table (row K: class out
  // of range), or c W in T (-1: out of range)
  template <bool CMOD>
  __device__ __forceinline__ int row_in(int ch) const {
    const int c = class_in<CMOD>(ch, p);
    if (SMEM) return (int)(tab + ((unsigned)c < (unsigned)p.K ? c : p.K) * (p.S + 1) * 2);
    return (unsigned)c < (unsigned)p.K ? c * p.W : -1;
  }
  __device__ __forceinline__ int row(int ch) const {
    return p.cmod ? row_in<true>(ch) : row_in<false>(ch);
  }
  // the chain: SMEM an add and one LDS
  __device__ __forceinline__ void step(int r) {
    if (SMEM) {
      x = lds16_at((uint32_t)r, (uint32_t)x);
    } else {
      const bool ok = r >= 0 && (unsigned)x < (unsigned)p.S;
      x = ok ? decode(T, r, x, p) : 0;
    }
  }
  // the state written after a step from xp on row r (off the chain): SMEM
  // with PAST (the table holds a next state past S) decodes one again from
  // T (r's class and xp / 2 < S)
  template <bool PAST = true>
  __device__ __forceinline__ int written(int r, int xp) const {
    if (!SMEM) return x;
    if (!PAST || x != 2 * p.S) return x >> 1;
    return decode(T, (r - (int)tab) / ((p.S + 1) * 2) * p.W, xp >> 1, p);
  }
  // the state clamped to [0, S]: what a chunk's guess and end compare
  __device__ __forceinline__ int key() const {
    if (SMEM) return x >> 1;
    return (unsigned)x < (unsigned)p.S ? x : p.S;
  }
};

// Stages the decoded table [K + 1][S + 1] uint16 (2 min(next, S); column S
// and row K zero) at `tab`, all the block's threads: 8 states of a row a
// unit (a 16-byte load of lo and of hi) where S and W are multiples of 8
// and T 16-byte aligned, else one state a unit; STAGE units' loads in
// flight.  Returns whether the block's table holds a next state past S
// (after the block's barrier).
__device__ bool stage_table(const uint16_t* __restrict__ T, uint16_t* tab, const Step& p) {
  const int S1 = p.S + 1, nthr = blockDim.x;
  for (int q = threadIdx.x; q < S1; q += nthr) tab[p.K * S1 + q] = 0;
  for (int q = threadIdx.x; q < p.K; q += nthr) tab[q * S1 + p.S] = 0;
  bool past = false;
  auto put = [&](int c, int s, int v) {
    past |= v >= p.S;
    tab[c * S1 + s] = (uint16_t)(2 * min(v, p.S));
  };
  if (p.S % 8 == 0 && p.W % 8 == 0 && (uintptr_t)T % 16 == 0) {
    const int s8 = p.S / 8, n = p.K * s8;
    for (int q0 = threadIdx.x; q0 < n; q0 += STAGE * nthr) {
      uint4 lo[STAGE], hi[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * nthr;
        const uint4* row = (const uint4*)(T + (size_t)(q < n ? q / s8 : 0) * p.W);
        const int k = q < n ? q % s8 : 0;
        lo[u] = __ldg(row + k);
        hi[u] = p.hilo ? __ldg(row + s8 + k) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * nthr;
        if (q >= n) continue;
        const uint32_t l4[4] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w};
        const uint32_t h4[4] = {hi[u].x, hi[u].y, hi[u].z, hi[u].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int v = bf16_value((uint16_t)(l4[e / 2] >> (16 * (e % 2))));
          if (p.hilo) v += 256 * bf16_value((uint16_t)(h4[e / 2] >> (16 * (e % 2))));
          put(q / s8, (q % s8) * 8 + e, p.smod ? v % p.S : v);
        }
      }
    }
  } else {
    const int n = p.K * p.S;
    for (int q0 = threadIdx.x; q0 < n; q0 += STAGE * nthr) {
      int v[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int q = q0 + u * nthr;
        v[u] = q < n ? decode(T, q / p.S * p.W, q % p.S, p) : 0;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (q0 + u * nthr < n) put((q0 + u * nthr) / p.S, (q0 + u * nthr) % p.S, v[u]);
    }
  }
  return __syncthreads_or(past);
}

// Walks positions [a, e) of string b from the walker's state; STORE writes
// each position's state to out (PAST: as Walker::written).  The chars of
// the next RG - 1 groups are copied into the warp's ring (`ring`: this
// lane's word of its first row), a row of 32 strings a position: with
// vec (TB a multiple of 4, chars 16-byte aligned) in 16-byte pieces, four
// strings a copy, two copies a lane a group; else each lane its own word.
template <int RG, bool SMEM, bool STORE, bool PAST = false>
__device__ __forceinline__ void walk(Walker<SMEM>& wk, uint32_t* ring,
                                     const int32_t* __restrict__ chars,
                                     int32_t* __restrict__ out, int TB, int b, bool live, int a,
                                     int e, bool vec) {
  const int n_groups = (e - a + LGROUP - 1) / LGROUP;
  const int32_t* src = chars + (size_t)a * TB + b;  // the next group's first char
  int32_t* dst = out + (size_t)a * TB + b;           // the next position's state
  const uint32_t ring_s = hopper::smem_u32(ring);
  auto copy4 = [](uint32_t dst, const int32_t* from) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(from) : "memory");
  };
  const int lane = threadIdx.x & 31;
  auto fetch = [&](int g) {  // group g's chars into slot g % RG; an empty group past e
    if (vec && g < n_groups) {
      const uint32_t to = ring_s - 4 * lane + (uint32_t)((g % RG) * LGROUP_BYTES);
#pragma unroll
      for (int k = 0; k < LGROUP * 8 / 32; ++k) {
        const int q = lane + 32 * k, j = q >> 3, c = q & 7;  // position j, strings 4c ..
        if (a + g * LGROUP + j < e && b - lane + 4 * c < TB)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to + j * 128 + c * 16),
                       "l"(src - lane + (size_t)j * TB + 4 * c)
                       : "memory");
      }
      src += (size_t)LGROUP * TB;
    } else if (!vec && live && g < n_groups) {
      const uint32_t to = ring_s + (uint32_t)((g % RG) * LGROUP_BYTES);
      const int32_t* sj = src;
      if (a + (g + 1) * LGROUP <= e) {  // a whole group
#pragma unroll
        for (int j = 0; j < LGROUP; ++j, sj += TB) copy4(to + j * 128, sj);
      } else {
#pragma unroll
        for (int j = 0; j < LGROUP; ++j, sj += TB)
          if (a + g * LGROUP + j < e) copy4(to + j * 128, sj);
      }
      src += (size_t)LGROUP * TB;
    }
    probe_ring::commit();
  };
  // group g's rows: a row's shared address (or c W) for each position
  auto rows = [&](int g, int (&row)[LGROUP]) {
    const uint32_t* slot = ring + (g % RG) * LGROUP * 32;
    if (wk.p.cmod) {
#pragma unroll
      for (int j = 0; j < LGROUP; ++j) row[j] = wk.template row_in<true>((int)slot[j * 32]);
    } else {
#pragma unroll
      for (int j = 0; j < LGROUP; ++j) row[j] = wk.template row_in<false>((int)slot[j * 32]);
    }
  };
  for (int g = 0; g < RG - 1; ++g) fetch(g);
  probe_ring::wait_oldest<RG>();  // group 0 is in
  __syncwarp();
  int cur[LGROUP], nxt[LGROUP];
  rows(0, cur);
#pragma unroll 1
  for (int g = 0; g < n_groups; ++g) {
    __syncwarp();       // every lane has read slot (g - 1) % RG
    fetch(g + RG - 1);  // into it
    probe_ring::wait_oldest<RG - 1>();  // groups up to g + 1 are in
    __syncwarp();
    rows(g + 1, nxt);  // the next group's rows, under this group's chain (past e: unused)
    if (a + (g + 1) * LGROUP <= e) {  // a whole group: the chain alone, a step an add and a load
#pragma unroll
      for (int j = 0; j < LGROUP; ++j, dst += TB) {
        const int xp = wk.x;
        wk.step(cur[j]);
        if (STORE && live) *dst = wk.template written<PAST>(cur[j], xp);
      }
    } else {
#pragma unroll
      for (int j = 0; j < LGROUP; ++j, dst += TB) {
        if (a + g * LGROUP + j < e) {  // the same for the warp's lanes
          const int xp = wk.x;
          wk.step(cur[j]);
          if (STORE && live) *dst = wk.template written<PAST>(cur[j], xp);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LGROUP; ++j) cur[j] = nxt[j];
  }
  probe_ring::wait_all();
}

// LOOKUP's serial form and chunked S1: a block of LOOKUP_WARPS warps
// stages the decoded table (SMEM), then its first `sw` warps walk (each
// with a ring of RG groups), warp w
// item blockIdx.x sw + w: chunk item / groups of C positions (serial: one
// chunk, C = L), strings (item % groups) 32 + lane.  scr (S1 only): [2,
// n_ch, TB] int32, each chunk's guess, then its end.
template <bool SMEM, int RG>
__global__ void __launch_bounds__(LOOKUP_WARPS * 32)
wide_lookup_kernel(const uint16_t* __restrict__ T, const int32_t* __restrict__ chars,
                   const int32_t* __restrict__ entry, int32_t* __restrict__ out,
                   int32_t* __restrict__ scr, int TB, int L, Step p, int tab_bytes, int C,
                   int Wu, int sw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool past = SMEM && stage_table(T, (uint16_t*)smem, p);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (TB + 31) / 32, n_ch = (L + C - 1) / C;
  const int item = blockIdx.x * sw + w, c = item / groups;
  const int b = (item % groups) * 32 + lane;
  if (w >= sw || c >= n_ch) return;
  uint32_t* ring = (uint32_t*)(smem + tab_bytes) + w * (RG * LGROUP_BYTES / 4) + lane;
  const bool live = b < TB;
  Walker<SMEM> wk{T, hopper::smem_u32(smem), p, 0};
  wk.enter(live ? entry[b] : 0);
  const int cs = c * C, ce = min(cs + C, L), ws = max(0, cs - Wu);
  const bool vec = TB % 4 == 0 && (uintptr_t)chars % 16 == 0;
  walk<RG, SMEM, false>(wk, ring, chars, out, TB, b, live, ws, cs, vec);
  if (scr != nullptr && live) scr[(size_t)c * TB + b] = wk.key();
  if (past)  // the table holds a next state past S: written as decoded again
    walk<RG, SMEM, true, true>(wk, ring, chars, out, TB, b, live, cs, ce, vec);
  else
    walk<RG, SMEM, true>(wk, ring, chars, out, TB, b, live, cs, ce, vec);
  if (scr != nullptr && live) scr[(size_t)(n_ch + c) * TB + b] = wk.key();
}

// The first chunk c >= c0 whose guess g[c] differs from chunk c - 1's
// stored end e[c - 1], or n_ch; 32 chunks' loads at a time.
__device__ __forceinline__ int next_mismatch(const int32_t* g, const int32_t* e, size_t TB,
                                             int c0, int n_ch) {
  constexpr int kAt = 32;
  for (int c = c0; c < n_ch; c += kAt) {
    int gv[kAt], ev[kAt];
#pragma unroll
    for (int j = 0; j < kAt; ++j) {
      const int k = min(c + j, n_ch - 1);
      gv[j] = g[(size_t)k * TB];
      ev[j] = e[(size_t)(k - 1) * TB];
    }
#pragma unroll
    for (int j = 0; j < kAt; ++j)
      if (c + j < n_ch && gv[j] != ev[j]) return c + j;
  }
  return n_ch;
}

// S2: a thread a string.  A block in which no chunk's guess differs from
// its predecessor's stored end has nothing to repair and stages nothing.
// A repair walks 16 positions a round, their chars and stored states loaded
// the round before.
template <bool SMEM>
__global__ void __launch_bounds__(REPAIR_THREADS)
wide_repair_kernel(const uint16_t* __restrict__ T, const int32_t* __restrict__ chars,
                   int32_t* __restrict__ out, const int32_t* __restrict__ scr,
                   unsigned long long* __restrict__ repaired, int TB, int L, Step p, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x * REPAIR_THREADS + threadIdx.x;
  const bool live = b < TB;
  const int n_ch = (L + C - 1) / C;
  const int32_t* g = scr + b;
  const int32_t* e = g + (size_t)n_ch * TB;
  int c = live ? next_mismatch(g, e, TB, 1, n_ch) : n_ch;
  if (!__syncthreads_or(c < n_ch)) return;
  if constexpr (SMEM) stage_table(T, (uint16_t*)smem, p);
  if (c >= n_ch) return;
  Walker<SMEM> wk{T, hopper::smem_u32(smem), p, 0};
  unsigned long long fixed = 0;
  int end = e[(size_t)(c - 1) * TB];  // chunk c - 1's true end (clamped)
  while (c < n_ch) {
    bool met = end == g[(size_t)c * TB];
    const int cs = c * C, ce = min(cs + C, L);
    wk.enter(end);
    if (!met) {
      int ch_n[16], old_n[16];
      auto load = [&](int p0, int* ch, int* old) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const size_t i = (size_t)min(p0 + j, ce - 1) * TB + b;
          ch[j] = chars[i];
          old[j] = out[i];
        }
      };
      load(cs, ch_n, old_n);
      for (int p0 = cs; p0 < ce && !met; p0 += 16) {
        int ch[16], old[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) ch[j] = ch_n[j], old[j] = old_n[j];
        if (p0 + 16 < ce) load(p0 + 16, ch_n, old_n);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (!met && p0 + j < ce) {
            const int r = wk.row(ch[j]), xp = wk.x;
            wk.step(r);
            const int s = wk.written(r, xp);
            if (s == old[j]) {
              met = true;
            } else {
              out[(size_t)(p0 + j) * TB + b] = s;
              ++fixed;
            }
          }
        }
      }
    }
    if (met) {  // the chunk's stored end is right: on to the next mismatch
      c = next_mismatch(g, e, TB, c + 1, n_ch);
      if (c < n_ch) end = e[(size_t)(c - 1) * TB];
    } else {
      end = wk.key();
      ++c;
    }
  }
  if (fixed) atomicAdd(repaired, fixed);
}

// -------------------------------------------------------------- ONEHOT_MMA

__device__ __forceinline__ uint32_t h2_bits(__half2 h) { return *(uint32_t*)&h; }

// fp16 bits of a small non-negative integer (exact under 2048)
__host__ __device__ constexpr uint32_t f16_bits(int v) {
  int e = 0;
  while (v >> (e + 1)) ++e;
  return v == 0 ? 0u : (uint32_t)(((e + 15) << 10) | ((v << (10 - e)) & 0x3FF));
}

// (x == k) on each half of a half2: 1.0 or 0.0 (HSET2); volatile, so that
// the compiler keeps each A fragment in its own registers until its wgmma
// retires rather than computing it again (a register reused under a
// wgmma in flight makes ptxas wait for each wgmma before the next)
__device__ __forceinline__ uint32_t eq2(uint32_t x, uint32_t k) {
  uint32_t e;
  asm volatile("set.eq.f16x2.f16x2 %0, %1, %2;\n" : "=r"(e) : "r"(x), "r"(k));
  return e;
}

// a bf16 pair (two integers under 2^16) as an f16 pair: exact
__device__ __forceinline__ uint32_t bf16x2_to_f16x2(uint32_t w) {
  return h2_bits(__floats2half2_rn(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u)));
}

// v mod S for 0 <= v < 2^16 and S <= 1024 off the integer divider: the
// quotient from v / S in f32 (exact or one short), then one correction
__device__ __forceinline__ int mod_small(int v, int S, float inv_s) {
  const int r = v - __float2int_rz((float)v * inv_s) * S;
  return r >= S ? r - S : r;
}

// the mbarrier's phase of `parity` has completed, polled by the whole warp
// until every lane sees it: a loop ptxas knows to be uniform, so the
// wgmmas in flight across it are not serialised
__device__ __forceinline__ void warp_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = hopper::smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!__all_sync(0xffffffffu, done));
}

// this thread's cp.async groups: at most N still pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (v0, v1) = (a0, a1) where jn == j, else as they are: selects in registers
// (as asm, so that the compiler does not turn a chain of them into an
// indexed load of the accumulators from local memory)
__device__ __forceinline__ void sel_pair(float& v0, float& v1, int jn, int j, float a0,
                                         float a1) {
  asm("{\n .reg .pred q;\n setp.eq.s32 q, %2, %3;\n selp.f32 %0, %4, %0, q;\n"
      " selp.f32 %1, %5, %1, q;\n}\n"
      : "+f"(v0), "+f"(v1)
      : "r"(jn), "r"(j), "f"(a0), "f"(a1));
}

// the shared::cluster address of `addr` (this block's shared memory) in rank r
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(addr), "r"(r));
  return d;
}

// v (16 bytes) into `addr` of a rank's shared memory (both addresses
// shared::cluster), its bytes counted on that rank's mbarrier `bar`: no
// fence, the receiver's wait on `bar` orders it
__device__ __forceinline__ void st_async4(uint32_t addr, const uint32_t (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the product form's shared memory: T's slice (kTiles x 128 columns, 64 k
// a 128-byte row, chunks of 64 k), the chars' ring [kMmaRing][GROUP][64],
// the staged states [kObuf][GROUP][64], the exchange [kSlots][kMaxCluster
// senders][4 warps][16 words] and its mbarriers [kSlots][4 warps]
__host__ __device__ constexpr int mma_slice_bytes(int Kt) {
  return (Kt + 3) / 4 * kTiles * kMmaN * 128;
}
constexpr int kRingWords = kMmaRing * GROUP * kStrings;
constexpr int kObufWords = kObuf * GROUP * kStrings;
constexpr int kXbufWords = kSlots * kMaxCluster * kStrings;
__host__ __device__ constexpr int mma_smem_bytes(int Kt) {
  return 1024 + mma_slice_bytes(Kt) + (kRingWords + kObufWords + kXbufWords) * 4 +
         kSlots * 4 * 8;
}

// ONEHOT_MMA: a cluster of R blocks (one warpgroup each) takes 64 strings;
// rank r holds columns [r NR, min((r + 1) NR, W)) of T.  frags: the
// wrapper's b_fragments, [ceil(W / 8)][ceil(K / 16)][32 lanes] uint2: lane
// 4 n8 + q holds rows (k, k + 1) and (k + 8, k + 9), k = 16 kt + 2 q, of
// column 8 nt + n8 as bf16 pairs, zero past K and W.  KT: the k tiles a
// step multiplies, ceil(K / 16) rounded up to an instance's (a runtime
// count would put each wgmma under a branch, where ptxas waits for each
// before the next).
template <int KT>
__global__ void __launch_bounds__(128, 1)
wide_mma_kernel(const uint2* __restrict__ frags, const int32_t* __restrict__ chars,
                const int32_t* __restrict__ entry, int32_t* __restrict__ out, int TB, int L,
                Step p, int R, int NR) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* smem = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  const int Kt = (p.K + 15) / 16;  // the fragments' k tiles (<= KT)
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  // the rank (the cluster's blocks are consecutive in x: %cluster_ctarank,
  // known uniform to the compiler)
  const int rank = (int)(blockIdx.x % R), b0 = blockIdx.x / R * kStrings;
  const int c0 = rank * NR, ncol = max(0, min(NR, p.W - c0));  // the rank's columns
  constexpr int NTOT = kTiles * kMmaN;
  int32_t* ring = (int32_t*)(smem + mma_slice_bytes(KT));
  int32_t* obuf = ring + kRingWords;
  uint32_t* xbuf = (uint32_t*)(obuf + kObufWords);  // [slot][sender][warp][16]
  uint64_t* mbar = (uint64_t*)(xbuf + kXbufWords);   // [slot][warp]
  const uint32_t tab = hopper::smem_u32(smem);

  // the slice, K-major under SW128: unit (n, k8) holds k 8 k8 .. 8 k8 + 7 of column c0 + n
  for (int u = tid; u < NTOT * ((KT + 3) / 4) * 8; u += 128) {
    const int n = u % NTOT, k8 = u / NTOT;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (n < ncol && k8 < 2 * Kt) {
      const int col = c0 + n;
      const uint2* f = frags + ((size_t)(col / 8) * Kt + k8 / 2) * 32 + 4 * (col % 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 x = __ldg(f + q);
        v[q] = bf16x2_to_f16x2(k8 % 2 ? x.y : x.x);
      }
    }
    *(uint4*)(smem + hopper::sw128_kmajor(n, 8 * k8, NTOT)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  hopper::fence_proxy_async();  // the slice's generic stores before wgmma reads it

  const int n_groups = (L + GROUP - 1) / GROUP;
  auto fetch = [&](int G) {  // group G's chars into slot G % kMmaRing; an empty group past L
    if (G < n_groups) {
      for (int q = tid; q < GROUP * kStrings; q += 128) {
        const int j = q / kStrings, m = q % kStrings, i = G * GROUP + j, b = b0 + m;
        if (i < L && b < TB)
          probe_ring::copy4((uint32_t*)&ring[((G % kMmaRing) * GROUP + j) * kStrings + m],
                            chars + (size_t)i * TB + b);
      }
    }
    probe_ring::commit();
  };
  auto store = [&](int G) {  // group G's staged states, by rank G % R
    if (G % R != rank) return;
    for (int q = tid; q < GROUP * kStrings; q += 128) {
      const int j = q / kStrings, m = q % kStrings, i = G * GROUP + j, b = b0 + m;
      if (i < L && b < TB) out[(size_t)i * TB + b] = obuf[((G % kObuf) * GROUP + j) * kStrings + m];
    }
  };
  for (int G = 0; G < kMmaRing - 1; ++G) fetch(G);
  if (tid < kSlots * 4) hopper::mbar_init(&mbar[tid], 1);
  hopper::fence_barrier_init();
  // where a lane of an even row pair g sends its words and its neighbour's
  // (rows g, g + 8, g + 1, g + 9: words 2 g .. 2 g + 3 of the warp's 16):
  // ranks tig, tig + 4, ..., into their exchange [slot 0][this rank][this
  // warp], counted on their slot-0 mbarrier of this warp
  const int m0 = 16 * w + g;  // this thread's rows m0, m0 + 8
  uint32_t xr[kMaxCluster / 4], mr[kMaxCluster / 4];
#pragma unroll
  for (int i = 0; i < kMaxCluster / 4; ++i) {
    const uint32_t r = (uint32_t)min(tig + 4 * i, R - 1);
    xr[i] = map_rank(hopper::smem_u32(xbuf + (rank * 4 + w) * 16 + 2 * g), r);
    mr[i] = map_rank(hopper::smem_u32(mbar + w), r);
  }
  int s[2];  // the rows' states
#pragma unroll
  for (int h = 0; h < 2; ++h) s[h] = b0 + m0 + 8 * h < TB ? entry[b0 + m0 + 8 * h] : 0;

  const __half2 off = __floats2half2_rn((float)(2 * tig), (float)(2 * tig + 1));
  const float inv_s = 1.f / (float)p.S;
  float acc[kTiles][kMmaN / 2];
  uint32_t a[KT][4];
#pragma unroll
  for (int u = 0; u < kTiles; ++u)
#pragma unroll
    for (int e = 0; e < kMmaN / 2; ++e) acc[u][e] = 0.f;
  // position t's products into acc: the one-hot of rows m0, m0 + 8's classes (a
  // class out of range matches no column) times the slice
  auto issue = [&](int t) {
    const int32_t* grp = ring + ((t / GROUP) % kMmaRing * GROUP + t % GROUP) * kStrings;
    int c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = class_of(grp[m0 + 8 * h], p);
      c[h] = (unsigned)c[h] < (unsigned)p.K ? c[h] : -1024;
    }
    const uint32_t xl = h2_bits(__hsub2(__half2half2(__int2half_rn(c[0])), off));
    const uint32_t xh = h2_bits(__hsub2(__half2half2(__int2half_rn(c[1])), off));
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t k0 = f16_bits(16 * kt) * 0x10001u, k8 = f16_bits(16 * kt + 8) * 0x10001u;
      a[kt][0] = eq2(xl, k0);
      a[kt][1] = eq2(xh, k0);
      a[kt][2] = eq2(xl, k8);
      a[kt][3] = eq2(xh, k8);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int u = 0; u < kTiles; ++u)
        hopper::wgmma_m64n128k16_f16_rs(
            acc[u], a[kt],
            hopper::sw128_desc(tab + hopper::sw128_kmajor(u * kMmaN, 16 * kt, NTOT), 16, 1024),
            kt > 0);
    }
    hopper::wgmma_commit();
  };
  auto land = [&]() {
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int e = 0; e < kMmaN / 2; ++e) hopper::fence_operand(acc[u][e]);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int q = 0; q < 4; ++q) hopper::fence_operand(a[kt][q]);
  };
  // row h's sum at the rank's column n (0 <= n < ncol, held by lane tig =
  // (n / 2) % 4): a masked select of the thread's registers
  auto pick = [&](int h, int n) {
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int j = 0; j < kMmaN / 8; ++j)
        sel_pair(v0, v1, n >> 3, u * (kMmaN / 8) + j, acc[u][4 * j + 2 * h],
                 acc[u][4 * j + 2 * h + 1]);
    return (int)(n & 1 ? v1 : v0);
  };

  // every rank has started (its exchange and mbarriers exist) and staged
  // its slice
  __syncthreads();
  cluster_arrive();
  cluster_wait();
  cp_wait<kMmaRing - 2>();  // group 0 is in
  __syncthreads();
  issue(0);
#pragma unroll 1
  for (int t = 0; t < L; ++t) {
    const int q = t % kSlots;
    land();
    // the picks of position t from the states before it, lo at column s and
    // hi at S + s, in uniform code (ptxas serialises the wgmmas whose sums
    // a divergent path reads): this rank's words of the row pair, 0 where
    // another rank holds the column (or the state is out of range), summed
    // over the row's four lanes (one holds it at most)
    int x[4];  // [h0 lo, h0 hi, h1 lo, h1 hi]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = (unsigned)s[h] < (unsigned)p.S;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int n = s[h] + k * p.S - c0;
        const int v = pick(h, n);
        x[2 * h + k] = in && (k == 0 || p.hilo) && (unsigned)n < (unsigned)ncol &&
                               ((n >> 1) & 3) == tig ? v : 0;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] += __shfl_xor_sync(0xffffffffu, x[e], 1);
      x[e] += __shfl_xor_sync(0xffffffffu, x[e], 2);
    }
    // every rank sends every rank its word of each row every step, lo + 2^16
    // hi (each under 2^16; 0 where another rank holds the column), two row
    // pairs a 16-byte st.async (64 a warp a step): a warp's mbarrier counts
    // R x 64 bytes, and a rank that has every rank's words of step t knows
    // that every rank has read the slot's words of step t - 2
    const uint32_t w0 = (uint32_t)x[0] | (uint32_t)x[1] << 16;  // row m0
    const uint32_t w1 = (uint32_t)x[2] | (uint32_t)x[3] << 16;  // row m0 + 8
    const uint32_t msg[4] = {w0, w1, __shfl_down_sync(0xffffffffu, w0, 4),
                             __shfl_down_sync(0xffffffffu, w1, 4)};
    if (lane == 0) hopper::mbar_expect_tx(&mbar[q * 4 + w], (uint32_t)R * 64);
#pragma unroll
    for (int i = 0; i < kMaxCluster / 4; ++i)
      if (!(g & 1) && tig + 4 * i < R)
        st_async4(xr[i] + q * (kMaxCluster * kStrings * 4), msg, mr[i] + q * 32);
    if (t + 1 < L) {
      if ((t + 1) % GROUP == 0) {  // position t + 1 starts group G
        const int G = (t + 1) / GROUP;
        cp_wait<kMmaRing - 3>();     // groups up to G are in
        hopper::named_sync(1, 128);  // every thread's, and group G - 2's states are staged
        fetch(G + kMmaRing - 2);     // into group G - 2's slot
        if (G >= 2) store(G - 2);
      }
      issue(t + 1);  // runs under the exchange
    }
    warp_wait(&mbar[q * 4 + w], (t / kSlots) & 1);  // every rank's words are in
    // lane l sums word l % 16 (row 16 w + l % 16 / 2 + 8 (l % 2)) of ranks 8
    // (l / 16) .. + 7; a row's lanes gather its sum
    const uint32_t* from = xbuf + (q * kMaxCluster * 4 + w) * 16 + (lane & 15);
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < kMaxCluster / 2; ++i) {
      const int r = (lane >> 4) * (kMaxCluster / 2) + i;
      sum += r < R ? from[r * 4 * 16] : 0u;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    int y[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = __shfl_sync(0xffffffffu, sum, 2 * g + h);
      y[2 * h] = (int)(v & 0xFFFF);
      y[2 * h + 1] = (int)(v >> 16);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = y[2 * h] + 256 * y[2 * h + 1];  // hi is 0 but with hilo
      s[h] = p.smod ? mod_small(v, p.S, inv_s) : v;
      // the row's four lanes store the same word (no branch while products fly)
      obuf[((t / GROUP) % kObuf * GROUP + t % GROUP) * kStrings + m0 + 8 * h] = s[h];
    }
  }
  hopper::named_sync(1, 128);
  for (int G = max(0, n_groups - 2); G < n_groups; ++G) store(G);
  probe_ring::wait_all();
}

// ------------------------------------------------------------------- COUNT

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

// ---------------------------------------------------------------- launches

int sms_and_optin(int* sms, int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// the serial form (C = 0: one chunk of L) or S1 and S2 (chunks of C, warm-up Wu)
template <bool SMEM>
int launch_lookup(const void* T, const void* chars, const void* entry, void* out, void* scratch,
                  void* repaired, int TB, int L, const Step& p, int C, int Wu, cudaStream_t st) {
  const int tab_bytes = SMEM ? ((p.K + 1) * (p.S + 1) * 2 + 15) / 16 * 16 : 0;
  int sms = 0, optin = 0;
  int err = sms_and_optin(&sms, &optin);
  if (err) return err;
  const int groups = (TB + 31) / 32, n_ch = C > 0 ? (L + C - 1) / C : 1;
  const int items = n_ch * groups;
  // walking warps a block: 4 serial; chunked about one block an SM
  const int sw = C > 0 ? min(SCAN_WARPS, (items + sms - 1) / sms) : SCAN_WARPS;
  // the deeper ring where it fits beside the table
  const bool deep = (size_t)tab_bytes + (size_t)sw * RING * LGROUP_BYTES <= (size_t)optin;
  const size_t smem = (size_t)tab_bytes + (size_t)sw * (deep ? RING : 4) * LGROUP_BYTES;
  if (smem > (size_t)optin || (C > 0 && (scratch == nullptr || repaired == nullptr || Wu < 0)))
    return (int)cudaErrorInvalidValue;
  auto kern = deep ? wide_lookup_kernel<SMEM, RING> : wide_lookup_kernel<SMEM, 4>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(items + sw - 1) / sw, LOOKUP_WARPS * 32, smem, st>>>(
      (const uint16_t*)T, (const int32_t*)chars, (const int32_t*)entry, (int32_t*)out,
      C > 0 ? (int32_t*)scratch : nullptr, TB, L, p, tab_bytes, C > 0 ? C : L, C > 0 ? Wu : 0,
      sw);
  e = cudaGetLastError();
  if (e != cudaSuccess || C <= 0) return (int)e;
  auto rep = wide_repair_kernel<SMEM>;
  e = cudaFuncSetAttribute(rep, cudaFuncAttributeMaxDynamicSharedMemorySize, tab_bytes);
  if (e != cudaSuccess) return (int)e;
  rep<<<(TB + REPAIR_THREADS - 1) / REPAIR_THREADS, REPAIR_THREADS, tab_bytes, st>>>(
      (const uint16_t*)T, (const int32_t*)chars, (int32_t*)out, (const int32_t*)scratch,
      (unsigned long long*)repaired, TB, L, p, C);
  return (int)cudaGetLastError();
}

// a cluster of R = ceil(W / 128) ranks (at most kMaxCluster) a group of 64 strings
template <int KT>
int launch_mma(const void* frags, const void* chars, const void* entry, void* out, int TB, int L,
               const Step& p, cudaStream_t st) {
  const int R = min(kMaxCluster, (p.W + kMmaN - 1) / kMmaN);
  const int NR = ((p.W + R - 1) / R + 7) / 8 * 8;
  if (NR > kTiles * kMmaN) return (int)cudaErrorInvalidValue;
  const int smem = mma_smem_bytes(KT);
  auto kern = wide_mma_kernel<KT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && R > 8)  // past the portable cluster size
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((TB + kStrings - 1) / kStrings * R);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const uint2*)frags, (const int32_t*)chars,
                         (const int32_t*)entry, (int32_t*)out, TB, L, p, R, NR);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// form 0 LOOKUP (in_smem: the decoded table in shared memory; C > 0: the
// chunked form, chunks of C positions after a warm-up of Wu, scratch [2,
// ceil(L / C), TB] int32 and the repaired counter, one unsigned 64-bit
// word; two launches), 1 ONEHOT_MMA (frags required), 2 COUNT; T [K, W]
// bf16 bits, W = S or 2S (hilo); chars [L, TB], entry [TB], out [L, TB] int32
extern "C" int h2r_dfa_wide(const void* T, const void* frags, const void* chars,
                            const void* entry, void* out, void* scratch, void* repaired, int TB,
                            int L, int K, int W, int hilo, int cmod, int smod, int form,
                            int in_smem, int C, int Wu, void* stream) {
  if (TB <= 0 || L <= 0 || K < 1 || K > 256 || W < 1 || W > MAX_W || (hilo && W % 2) ||
      (form == ONEHOT_MMA && frags == nullptr) || (form != LOOKUP && (in_smem || C)))
    return (int)cudaErrorInvalidValue;
  const Step p{K, hilo ? W / 2 : W, W, hilo != 0, cmod != 0, smod != 0};
  cudaStream_t st = (cudaStream_t)stream;
  if (form == LOOKUP && in_smem)
    return launch_lookup<true>(T, chars, entry, out, scratch, repaired, TB, L, p, C, Wu, st);
  if (form == LOOKUP)
    return launch_lookup<false>(T, chars, entry, out, scratch, repaired, TB, L, p, C, Wu, st);
  if (form == ONEHOT_MMA) {  // the k tiles' instance: 2, 4, 6, 8, 12 or 16
    const int kt = (K + 15) / 16;
    if (kt <= 2) return launch_mma<2>(frags, chars, entry, out, TB, L, p, st);
    if (kt <= 4) return launch_mma<4>(frags, chars, entry, out, TB, L, p, st);
    if (kt <= 6) return launch_mma<6>(frags, chars, entry, out, TB, L, p, st);
    if (kt <= 8) return launch_mma<8>(frags, chars, entry, out, TB, L, p, st);
    if (kt <= 12) return launch_mma<12>(frags, chars, entry, out, TB, L, p, st);
    return launch_mma<16>(frags, chars, entry, out, TB, L, p, st);
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
