// bitop_scan -- the serial bit-op scan of tools/probe_tpu20.py (A) as an
// H100 kernel: what a step of N_OPS dependent and/or/xor ops on 32-bit
// words costs on this card, at the bitplane scan's (K2's) geometry.
//
// Replaces the TPU kernel made by make_scan_probe (tools/probe_tpu20.py:42,
// pallas_call at :74).  Per word (32 strings) and step i of L: the SB
// state planes and the running acc go through N_OPS ops, op t reading
// plane t % SB and class plane t % K of step i:
//   t % 3 == 0: acc ^= plane & cls
//   t % 3 == 1: acc |= plane & ~cls
//   t % 3 == 2: plane = plane ^ acc (later ops of the step read it);
// then out[i] = acc.  The planes carry across all of L; acc restarts from
// plane 0 at the first step of every chunk of LC steps (the probe's
// fori_loop over a grid step starts from st_scr[0]).  The probe zeroes its
// planes at the first grid step, and every op keeps an all-zero state at
// zero; here the start planes st0 are an input (zeros reproduce the probe),
// so that a compiler cannot fold the loop away.
//
// Two forms, the same outputs.
//
// The serial form (bitop_scan_kernel): one thread owns one word and walks
// all L steps, N_OPS unrolled LOP3s a step on registers; blocks of 32
// threads, as bitplane_scan.cu's launch: at NW = 1024 words (the probe's 8
// x 128, K2's B = 32768) that is 32 warps, one on each of 32 SMs.  N_OPS,
// SB and K are template parameters, so every op t's t % 3, t % SB and t % K
// is a constant and the planes stay in registers.  The class words of the
// next RING - 1 steps are in flight to a shared-memory ring (probe_ring.cuh,
// K2's design), so a step waits on its chain alone.  What bounds it: the
// dependent chain through acc, N_OPS LOP3s a step.
//
// The table form (bitop_table_scan_kernel): every op is bitwise, so each
// string, one bit of a word, is an automaton of its own.  Its state is 6
// bits (the 5 planes in bits 0-4, acc in bit 5) and its input 12 class
// bits a step, so T[state, class] -> next state, 2^18 entries, is the whole
// step whatever N_OPS is.  bitop_table_kernel evaluates the op sequence
// once, bit-sliced (a thread 32 classes of one state), and packs T five
// 6-bit entries a 32-bit word, 820 words a state row (209,920 bytes).  The
// scan gives a string a lane and a word a warp; a block is 8 warps on 8
// consecutive words, so a class row of a step is one 32-byte sector.  T
// sits in dynamic shared memory (opt-in past 48 KB); the class words come
// through a cp.async ring of 3 stages of 16 steps, [word][step][class] with
// a padded word stride (no bank conflicts either side).
// A warp transpose of each 32 (step, class) rows (8 steps in 3 transposes;
// one SHFL, one funnel shift and one LOP3 a transpose stage) gives each
// lane its string's 12-bit class indices; the chain is then an IMAD, an
// LDS, a shift and a mask a step (st = T[st][idx]; at the first step of
// each chunk of LC, first st = (st & 31) | (st & 1) << 5).  With 8 warps an
// SM the chain's latency binds unless a warp has other work, so each ring
// stage's 16 steps run in one straight-line block with the transposes of
// the next stage (held in registers: the ring keeps two stages in flight).
// Each step's acc bits make the output word by __ballot_sync; lane 0
// stages a stage's 16 words at once, and they leave in 32-byte runs (8
// words of one step).  At NW = 1024 the grid is 128 blocks, one an SM (T
// fills its shared memory).
//
// Layouts: cls [L, K, NWS, 128] int32; st0 [SB, NWS, 128] int32; out [L,
// 1, NWS, 128] int32; NW = NWS * 128 words; T [64 x 820] uint32.
//
// bitop_carry, the carry mode, replaces probe_tpu20.py's E (kern2 :246,
// pallas_call at :267): per string group b and word w, a state carried
// across the chunks of LC positions, st ^= c & st for `steps` positions at
// the start of each chunk (the probe as written reads one, the first: its
// loop runs cls_ref.shape[0] = 1 trip), out[b, w] = st after the last
// chunk.  The probe starts each b from its zeroed scratch, which the op
// keeps at zero; here the start st0 [NW] is an input, as bitop_scan's.
// steps = LC is the carry scan the probe meant: every position in order.
// Layouts: cls [NB, L, NW] int32 (the probe's [NB, L, 1, NWS, 128]); st0
// [NW]; out [NB, NW]; L % LC == 0, 1 <= steps <= LC.  Two forms, the same
// outputs.
//
// The serial form (bitop_carry_kernel): the TPU carried st in VMEM scratch
// across the grid's chunk axis; here one thread owns one (b, w) and walks
// its chunks itself, the positions' words in flight through the same ring.
// What bounds it: the chain, one LOP3 a position, and the latency of its
// ring: 2048 threads at the probe's shape, 64 blocks of 32 on 64 SMs.
//
// The reduce form (bitop_carry_reduce_kernel): st ^= c & st is st & ~c, so
// out = st0 & ~(c_0 | c_1 | ...) over the positions read, an OR reduction
// in any order, exact for any input.  What bounds it: bytes, each word of
// the positions read once.  A warp owns a tile of 32 V words (V = 4: a
// lane's 16-byte load, where NW % 4 == 0 and cls, st0 and out are 16-byte
// aligned; else V = 1, 4-byte loads, in the same source) and a slice of
// consecutive positions; a block is 8 warps on one tile, and a cluster of
// `cluster` blocks (up to 16, past the portable 8 by opt-in) splits the
// positions, rank r the r-th run of per_rank, its warp w the w-th run of
// per_warp (the wrapper's `carry_geometry` picks `cluster`: two blocks an
// SM where every warp then has a batch of loads, else fewer; at the probe's
// 8 positions one block a tile, no cluster).  A lane issues 8 loads before
// it ORs them, so each SM holds tens of KB in flight; rank 0 reads its st0
// words beside them.  The warps' ORs meet in the block's shared memory,
// each rank's in rank 0's (distributed shared memory), and rank 0 masks st0
// and writes the tile: one writer a word, no zero fill, one launch a call.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 32;
constexpr int RING = 16;  // steps of class words in the ring (RING - 1 in flight): 24 KiB

template <int N_OPS, int SB, int K>
__global__ void __launch_bounds__(THREADS)
bitop_scan_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                  int32_t* __restrict__ out, int NW, int L, int LC) {
  __shared__ uint32_t ring[RING][K][THREADS];  // step p's class words in slot p % RING
  const int t = threadIdx.x;
  const int w = blockIdx.x * THREADS + t;
  if (w >= NW) return;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < L) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        probe_ring::copy4(&ring[p % RING][c][t], cls + ((size_t)p * K + c) * NW + w);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  uint32_t planes[SB];
#pragma unroll
  for (int j = 0; j < SB; ++j) planes[j] = (uint32_t)st0[(size_t)j * NW + w];
  uint32_t acc = 0;
  int in_chunk = 0;
#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    fetch(i + RING - 1);  // into slot (i - 1) % RING, read at i - 1
    probe_ring::wait_oldest<RING>();
    uint32_t cw[K];
#pragma unroll
    for (int c = 0; c < K; ++c) cw[c] = ring[i % RING][c][t];
    if (in_chunk == 0) acc = planes[0];
    if (++in_chunk == LC) in_chunk = 0;
#pragma unroll
    for (int op = 0; op < N_OPS; ++op) {
      const uint32_t a = planes[op % SB], c = cw[op % K];
      if (op % 3 == 0)
        acc ^= a & c;
      else if (op % 3 == 1)
        acc |= a & ~c;
      else
        planes[op % SB] = a ^ acc;
    }
    out[(size_t)i * NW + w] = (int32_t)acc;
  }
  probe_ring::wait_all();
}

// ------------------------------------------------------------ the table form

constexpr int kTabSB = 5, kTabK = 12;
constexpr int kTabStates = 1 << (kTabSB + 1);  // 64: 5 planes and acc
constexpr int kTabClasses = 1 << kTabK;        // 4096
constexpr int kTabPerWord = 5;                 // 6-bit entries a 32-bit word
constexpr int kTabRowWords = (kTabClasses + kTabPerWord - 1) / kTabPerWord;  // 820
constexpr int kTabWords = kTabStates * kTabRowWords;                         // 52,480
constexpr int kBuildThreads = kTabClasses / 32;  // a thread 32 classes of a state row

constexpr int kTsWarps = 8;  // words a block
constexpr int kTsThreads = 32 * kTsWarps;
constexpr int kTsG = 16;                          // steps a ring stage
constexpr int kTsStages = 3;                      // stages in the ring (2 in flight)
constexpr int kTsRows = kTsG * kTabK;             // (step, class) rows of a stage: 192
constexpr int kTsX = kTsRows / 32;                // a string's transposed words a stage: 6
constexpr int kTsCol = kTsRows + 4;               // one word's class words of a stage, padded
constexpr int kTsStageWords = kTsWarps * kTsCol;  // 1568
constexpr int kTsOutRow = kTsG + 4;               // a warp's staged output words, padded
constexpr int kTsSmemBytes =
    4 * (kTabWords + kTsStages * kTsStageWords + 2 * kTsWarps * kTsOutRow);  // 230,016

// T for N_OPS (sb = 5, k = 12): a block a state row, a thread the 32
// classes 32 t + b (bit b of its words), bit-sliced as the serial kernel
// runs the ops; then the row's entries packed five a word.
template <int N_OPS>
__global__ void __launch_bounds__(kBuildThreads) bitop_table_kernel(uint32_t* __restrict__ tab) {
  __shared__ uint8_t ent[kTabClasses];
  const uint32_t st = blockIdx.x, t = threadIdx.x;
  constexpr uint32_t kLow[5] = {0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u, 0xFF00FF00u, 0xFFFF0000u};
  uint32_t cw[kTabK];
#pragma unroll
  for (int c = 0; c < kTabK; ++c)
    cw[c] = c < 5 ? kLow[c < 5 ? c : 0] : 0u - ((t >> (c < 5 ? 0 : c - 5)) & 1u);
  uint32_t planes[kTabSB];
#pragma unroll
  for (int j = 0; j < kTabSB; ++j) planes[j] = 0u - ((st >> j) & 1u);
  uint32_t acc = 0u - ((st >> kTabSB) & 1u);
#pragma unroll
  for (int op = 0; op < N_OPS; ++op) {
    const uint32_t a = planes[op % kTabSB], c = cw[op % kTabK];
    if (op % 3 == 0)
      acc ^= a & c;
    else if (op % 3 == 1)
      acc |= a & ~c;
    else
      planes[op % kTabSB] = a ^ acc;
  }
#pragma unroll 4
  for (int b = 0; b < 32; ++b) {
    uint32_t e = ((acc >> b) & 1u) << kTabSB;
#pragma unroll
    for (int j = 0; j < kTabSB; ++j) e |= ((planes[j] >> b) & 1u) << j;
    ent[32 * t + b] = (uint8_t)e;
  }
  __syncthreads();
  for (int w = t; w < kTabRowWords; w += kBuildThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < kTabPerWord; ++i) {
      const int cls = kTabPerWord * w + i;
      if (cls < kTabClasses) word |= (uint32_t)ent[cls] << (6 * i);
    }
    tab[(size_t)st * kTabRowWords + w] = word;
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The warp transpose: lane r holds row r of a 32 x 32 bit matrix and ends
// with column r.  Each stage j = 16, 8, 4, 2, 1 swaps the off-diagonal j x
// j blocks: a lane keeps its bits under keep[k] and takes the others from
// lane r ^ j, rotated by rot[k] (j for the upper lanes, 32 - j for the
// lower) so that they land in place.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, const uint32_t (&keep)[5],
                                                const uint32_t (&rot)[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, 16 >> k);
    x = (x & keep[k]) | (__funnelshift_l(y, y, rot[k]) & ~keep[k]);
  }
  return x;
}

// One ring stage: the kTsG steps of the chain on this stage's transposed
// rows xs (the 192 class bits of a string, 12 a step, across kTsG * kTabK /
// 32 words), and, in the same straight-line code so that they fill the
// chain's wait, the transposes of the next stage's rows (col: this warp's
// word in its slot) into xn.  A step's word and shift in T's row come from
// one product: idx * 52429 = (idx / 5) << 18 | (6 (idx % 5)) << 13 | ...
// for idx < 4096.  The acc bits of the steps are gathered by ballot into
// words[], which lane 0 stages at the end.  Past L the steps run on stale
// indices and their words are never stored.  RESTART: a step of this stage
// starts a chunk of LC (acc from plane 0); else left counts down by the
// stage.
template <bool RESTART>
__device__ __forceinline__ void stage_steps(uint32_t& st, int& left, int LC,
                                            const uint32_t (&xs)[kTsX], uint32_t (&xn)[kTsX],
                                            const uint32_t* col, const uint32_t (&keep)[5],
                                            const uint32_t (&rot)[5], uint32_t tab,
                                            uint32_t* o, int lane) {
#pragma unroll
  for (int k = 0; k < kTsX; ++k) xn[k] = transpose32(col[32 * k + lane], keep, rot);
  uint32_t words[kTsG];
#pragma unroll
  for (int j = 0; j < kTsG; ++j) {
    constexpr int kMask = kTabClasses - 1;
    const int b = kTabK * j, k = b / 32, r = b % 32;  // step j's bits: b .. b + 11
    const uint32_t idx =
        (r + kTabK <= 32 ? xs[k] >> r : __funnelshift_r(xs[k], xs[k + (k + 1 < kTsX)], r)) & kMask;
    const uint32_t prod = idx * 52429u;
    const uint32_t at = tab + ((prod >> 16) & ~3u);  // 4 (idx / 5)
    const uint32_t sh = (prod >> 13) & 30u;          // 6 (idx % 5)
    if (RESTART) {
      if (left == 0) {
        st = (st & 31u) | ((st & 1u) << 5);
        left = LC;
      }
      --left;
    }
    uint32_t a, w;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(a) : "r"(st), "n"(4 * kTabRowWords), "r"(at));
    asm("ld.shared.u32 %0, [%1];" : "=r"(w) : "r"(a));
    words[j] = __ballot_sync(0xFFFFFFFFu, w & (32u << sh));
    st = (w >> sh) & 63u;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kTsG; j += 4)
      *(uint4*)(o + j) = make_uint4(words[j], words[j + 1], words[j + 2], words[j + 3]);
  }
  if (!RESTART) left -= kTsG;
}

__global__ void __launch_bounds__(kTsThreads, 1)
bitop_table_scan_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                        const uint32_t* __restrict__ gtab, int32_t* __restrict__ out, int NW,
                        int L, int LC) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem;
  uint32_t* ring = tab + kTabWords;                  // [stage][word g][step][class]
  uint32_t* ost = ring + kTsStages * kTsStageWords;  // [2][word g][step]
  const int t = threadIdx.x, g = t >> 5, lane = t & 31;
  const int w0 = blockIdx.x * kTsWarps;
  const int n_stage = (L + kTsG - 1) / kTsG;

  // T, then the first stages, each its own commit group
  for (int i = t; i < kTabWords / 4; i += kTsThreads)
    probe_ring::copy16(tab + 4 * i, gtab + 4 * i);
  probe_ring::commit();
  // a stage's (step, class) rows: this thread copies word gg of rows r0 +
  // 32 i (kTsThreads / kTsWarps = 32 rows a pass)
  constexpr int kRowsAPass = kTsThreads / kTsWarps;
  const int gg = t % kTsWarps, r0 = t / kTsWarps;
  const int32_t* src0 = cls + (size_t)r0 * NW + w0 + gg;
  const uint32_t dst0 = shared_addr(ring + gg * kTsCol + r0);
  auto fetch = [&](int s) {  // stage s into slot s % kTsStages; an empty group past L
    if (s < n_stage) {
      const int rows = min(kTsG, L - s * kTsG) * kTabK;
      const int32_t* src = src0 + (size_t)s * kTsRows * NW;
      const uint32_t dst = dst0 + 4u * (s % kTsStages) * kTsStageWords;
#pragma unroll
      for (int i = 0; i < kTsRows / kRowsAPass; ++i)
        if (r0 + kRowsAPass * i < rows)
          probe_ring::copy4(dst + 4u * kRowsAPass * i, src + (size_t)kRowsAPass * i * NW);
    }
    probe_ring::commit();
  };
  for (int s = 0; s < kTsStages; ++s) fetch(s);
  auto flush = [&](int s) {  // stage s's output words, 8 a step: 32-byte runs
    const int p = s * kTsG + (t >> 3);
    if (t < kTsG * kTsWarps && p < L)
      out[(size_t)p * NW + w0 + (t & 7)] =
          (int32_t)ost[(s & 1) * kTsWarps * kTsOutRow + (t & 7) * kTsOutRow + (t >> 3)];
  };

  // this lane's string: bit `lane` of each start plane; acc is set at step 0
  const int w = w0 + g;
  uint32_t st = 0;
#pragma unroll
  for (int j = 0; j < kTabSB; ++j) st |= (((uint32_t)st0[(size_t)j * NW + w] >> lane) & 1u) << j;
  constexpr uint32_t kLeft[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u, 0x55555555u};
  uint32_t keep[5], rot[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const bool top = !(lane & j);
    keep[k] = top ? kLeft[k] : ~kLeft[k];
    rot[k] = top ? j : 32 - j;
  }
  const uint32_t tab_at = shared_addr(tab);
  int left = 0;  // steps to the next restart of acc

  // stage 0's rows transposed; then each stage runs its steps beside the
  // next stage's transposes, while the two stages after it are in flight
  probe_ring::wait_pending<kTsStages - 1>();
  __syncthreads();
  uint32_t xs[kTsX], xn[kTsX];
#pragma unroll
  for (int k = 0; k < kTsX; ++k) xs[k] = transpose32(ring[g * kTsCol + 32 * k + lane], keep, rot);
#pragma unroll 1
  for (int s = 0; s < n_stage; ++s) {
    probe_ring::wait_pending<kTsStages - 2>();  // stage s + 1 has landed
    __syncthreads();                            // and stage s's slot is free
    if (s > 0) flush(s - 1);
    fetch(s + kTsStages);
    const uint32_t* col = ring + ((s + 1) % kTsStages) * kTsStageWords + g * kTsCol;
    uint32_t* o = ost + (s & 1) * kTsWarps * kTsOutRow + g * kTsOutRow;
    if (left >= kTsG)
      stage_steps<false>(st, left, LC, xs, xn, col, keep, rot, tab_at, o, lane);
    else
      stage_steps<true>(st, left, LC, xs, xn, col, keep, rot, tab_at, o, lane);
#pragma unroll
    for (int k = 0; k < kTsX; ++k) xs[k] = xn[k];
  }
  probe_ring::wait_all();
  __syncthreads();
  if (n_stage > 0) flush(n_stage - 1);
}

template <int N_OPS>
int launch_table(void* tab, cudaStream_t stream) {
  bitop_table_kernel<N_OPS><<<kTabStates, kBuildThreads, 0, stream>>>((uint32_t*)tab);
  return (int)cudaGetLastError();
}

template <int N_OPS>
int launch(const void* cls, const void* st0, void* out, int NW, int L, int LC,
           cudaStream_t stream) {
  bitop_scan_kernel<N_OPS, 5, 12><<<(NW + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const int32_t*)cls, (const int32_t*)st0, (int32_t*)out, NW, L, LC);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
bitop_carry_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                   int32_t* __restrict__ out, int NW, int L, int LC, int steps) {
  __shared__ uint32_t ring[RING][THREADS];  // position p's word in slot p % RING
  const int t = threadIdx.x, b = blockIdx.y;
  const int w = blockIdx.x * THREADS + t;
  if (w >= NW) return;
  const int n_pos = L / LC * steps;
  const int32_t* base = cls + (size_t)b * L * NW + w;
  auto fetch = [&](int p) {  // the p-th position read: chunk p / steps, its (p % steps)-th
    if (p < n_pos)
      probe_ring::copy4(&ring[p % RING][t], base + ((size_t)(p / steps) * LC + p % steps) * NW);
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  uint32_t st = (uint32_t)st0[w];
#pragma unroll 1
  for (int p = 0; p < n_pos; ++p) {
    fetch(p + RING - 1);  // into slot (p - 1) % RING, read at p - 1
    probe_ring::wait_oldest<RING>();
    const uint32_t c = ring[p % RING][t];
    st ^= c & st;
  }
  out[(size_t)b * NW + w] = (int32_t)st;
  probe_ring::wait_all();
}

// ------------------------------------------------------- the reduce form

constexpr int kRedWarps = 8;        // a block: 8 warps on one tile of words
constexpr int kRedThreads = 32 * kRedWarps;
constexpr int kRedMaxCluster = 16;  // blocks over the positions (past the portable 8: opted in)
constexpr int kRedBatch = 8;        // loads a lane issues before it ORs them

// a lane's words of a position: V = 4, one 16-byte load; V = 1, one word.
// The loads skip L1 (each word is read once) and ask L2 for whole 256-byte
// runs of the row (a warp reads 128 V bytes of it)
template <int V>
struct RedWord;
template <>
struct RedWord<4> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ T load(const T* p) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  }
  static __device__ __forceinline__ T or_(T a, T b) {
    return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
  }
  static __device__ __forceinline__ T andnot(T s, T c) {
    return make_uint4(s.x & ~c.x, s.y & ~c.y, s.z & ~c.z, s.w & ~c.w);
  }
};
template <>
struct RedWord<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ T load(const T* p) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
  }
  static __device__ __forceinline__ T or_(T a, T b) { return a | b; }
  static __device__ __forceinline__ T andnot(T s, T c) { return s & ~c; }
};

// grid: (tiles x cluster, NB), a cluster of `cluster` blocks (rank =
// blockIdx.x % cluster) on one tile of 32 V words of string group blockIdx.y
template <int V>
__global__ void __launch_bounds__(kRedThreads)
bitop_carry_reduce_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                          int32_t* __restrict__ out, int NW, int L, int LC, int steps,
                          int cluster, int per_rank, int per_warp) {
  using R = RedWord<V>;
  using T = typename R::T;
  __shared__ T part[kRedWarps][32];
  __shared__ T parts[kRedMaxCluster][32];  // rank 0's: every rank's
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % cluster, b = blockIdx.y;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int w0 = ((blockIdx.x / cluster) * 32 + lane) * V;  // this lane's first word
  const bool col = w0 < NW;  // V = 4 divides NW
  const int n_pos = L / LC * steps;
  const int r_lo = min(n_pos, rank * per_rank), r_hi = min(n_pos, r_lo + per_rank);
  const int lo = min(r_hi, r_lo + warp * per_warp), hi = min(r_hi, lo + per_warp);
  const T* base = reinterpret_cast<const T*>(cls + (size_t)b * L * NW + w0);
  const size_t row_t = NW / V;  // a position's row, in T
  int j = lo / steps, i = lo - j * steps;  // the chunk and position in it of p = lo
  T s = R::zero();  // rank 0's st0 words, read beside the positions
  if (rank == 0 && warp == 0 && col) s = __ldg(reinterpret_cast<const T*>(st0 + w0));
  T acc = R::zero();
#pragma unroll 1
  for (int p = lo; p < hi; p += kRedBatch) {
    T v[kRedBatch];
#pragma unroll
    for (int k = 0; k < kRedBatch; ++k) {
      v[k] = R::zero();
      if (col && p + k < hi) v[k] = R::load(base + (size_t)(j * LC + i) * row_t);
      if (++i == steps) {
        i = 0;
        ++j;
      }
    }
#pragma unroll
    for (int k = 0; k < kRedBatch; ++k) acc = R::or_(acc, v[k]);
  }
  part[warp][lane] = acc;
  __syncthreads();
  T sum = R::zero();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kRedWarps; ++k) sum = R::or_(sum, part[k][lane]);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
  cg::cluster_group cl = cg::this_cluster();
  if (warp == 0) cl.map_shared_rank(&parts[0][0], 0)[rank * 32 + lane] = sum;
  cl.sync();  // every rank's OR is in rank 0's memory
  if (rank == 0 && warp == 0 && col) {
    T all = R::zero();
#pragma unroll
    for (int r = 0; r < kRedMaxCluster; ++r)
      if (r < cluster) all = R::or_(all, parts[r][lane]);
    *reinterpret_cast<T*>(out + (size_t)b * NW + w0) = R::andnot(s, all);
  }
}

template <int V>
int launch_reduce(const void* cls, const void* st0, void* out, int NB, int NW, int L, int LC,
                  int steps, int cluster, cudaStream_t stream) {
  auto kernel = bitop_carry_reduce_kernel<V>;
  if (cluster > 8) {  // past the portable cluster size
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_pos = L / LC * steps;
  const int per_rank = (n_pos + cluster - 1) / cluster;
  const int per_warp = (per_rank + kRedWarps - 1) / kRedWarps;
  const int tiles = (NW + 32 * V - 1) / (32 * V);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, NB);
  cfg.blockDim = dim3(kRedThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1;  // a launch without clusters is a cluster of one block
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)cls, (const int32_t*)st0, (int32_t*)out,
                         NW, L, LC, steps, cluster, per_rank, per_warp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster 0: the serial form; 1 <= cluster <= min(16, the positions
// read): the reduce form on clusters of that many blocks
extern "C" int h2r_bitop_carry(const void* cls, const void* st0, void* out, int NB, int NW,
                               int L, int LC, int steps, int cluster, void* stream) {
  if (NB <= 0 || NB > 65535 || NW <= 0 || LC < 1 || L < LC || L % LC || steps < 1 ||
      steps > LC || cluster < 0 || cluster > kRedMaxCluster || cluster > L / LC * steps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster > 0) {
    if (NW % 4 == 0 && ((uintptr_t)cls | (uintptr_t)st0 | (uintptr_t)out) % 16 == 0)
      return launch_reduce<4>(cls, st0, out, NB, NW, L, LC, steps, cluster, st);
    return launch_reduce<1>(cls, st0, out, NB, NW, L, LC, steps, cluster, st);
  }
  const dim3 grid((NW + THREADS - 1) / THREADS, NB);
  bitop_carry_kernel<<<grid, THREADS, 0, st>>>((const int32_t*)cls, (const int32_t*)st0,
                                               (int32_t*)out, NW, L, LC, steps);
  return (int)cudaGetLastError();
}

// T of the table form for n_ops, into tab (kTabWords uint32)
extern "C" int h2r_bitop_table(void* tab, int n_ops, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_ops) {
    case 96: return launch_table<96>(tab, st);
    case 192: return launch_table<192>(tab, st);
    case 384: return launch_table<384>(tab, st);
    case 768: return launch_table<768>(tab, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the probe's sweep: n_ops in {96, 192, 384, 768}, sb = 5, k = 12.  tab
// null: the serial form; else the table form on T (built for n_ops by
// h2r_bitop_table; 16-byte aligned), NW a multiple of 8.
extern "C" int h2r_bitop_scan(const void* cls, const void* st0, const void* tab, void* out,
                              int n_ops, int NW, int L, int LC, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (LC < 1) return (int)cudaErrorInvalidValue;
  if (tab != nullptr) {
    if (NW % kTsWarps || ((uintptr_t)tab & 15)) return (int)cudaErrorInvalidValue;
    // the opt-in past 48 KB, once a device (a device past 63 sets it each call)
    static std::atomic<unsigned long long> opted{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(opted.load() & bit)) {
      e = cudaFuncSetAttribute(bitop_table_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTsSmemBytes);
      if (e != cudaSuccess) return (int)e;
      opted.fetch_or(bit);
    }
    bitop_table_scan_kernel<<<NW / kTsWarps, kTsThreads, kTsSmemBytes, st>>>(
        (const int32_t*)cls, (const int32_t*)st0, (const uint32_t*)tab, (int32_t*)out, NW, L,
        LC);
    return (int)cudaGetLastError();
  }
  switch (n_ops) {
    case 96: return launch<96>(cls, st0, out, NW, L, LC, st);
    case 192: return launch<192>(cls, st0, out, NW, L, LC, st);
    case 384: return launch<384>(cls, st0, out, NW, L, LC, st);
    case 768: return launch<768>(cls, st0, out, NW, L, LC, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
