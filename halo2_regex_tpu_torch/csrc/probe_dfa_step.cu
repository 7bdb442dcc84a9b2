// dfa_step -- the DFA-step probes of tools/ as one H100 kernel, three step
// forms: probe_tpu.py's k6 (pallas_call at :180, one-hot product) and k7
// (:224, lookup), probe_tpu2.py's C (k, :118, one-hot product) and D (k2,
// :169, class-factored product), and probe_tpu3.py's make_scan_fullwidth
// and make_scan_select (vmem_call, :47).
//
// The function: the DFA scan s <- T[c, s] from s = 0, every state written:
// T [256, 128] with values in [0, 128), bytes in [0, 256), batch-major
// [TB, LB] or time-major [LB, TB], out the same layout, int32.  The forms:
//   LOOKUP:     T resident in shared memory as it is (int32, 128 KiB), a
//               lane a string, s = T[c, s] by one LEA and one LDS a step
//               (k7; dfa_lookup_kernel below).
//   ONEHOT_MMA: a warpgroup takes 64 strings; each step forms the one-hot
//               of their 64 bytes in registers, as wgmma's A operand (a
//               warp's 16 rows, mma.sync's m16k16 A fragment) in f16, and
//               multiplies it by the whole T (the B operand: f16, K-major,
//               resident in shared memory under the 128-byte swizzle, 64
//               KiB) with 16 wgmma m64n128k16 and f32 sums: the probe's
//               whole K = 256 x N = 128 (k6, C, fullwidth, select).  Then
//               it picks column s of each row.
//   CLASS_MMA:  the same warpgroup and one-hot, then two products: 16 wgmma
//               m64n16k16 by C [256, 16], the one-hot of the byte classes
//               (one chain of k16 slices, f32 sums), whose sum,
//               converted, is the class one-hot
//               as the next A operand (an m64n16 accumulator is a k16 A
//               fragment), then one m64n128k16 by Tk [16, 128] (D): T =
//               Tk[classes].
// The one-hot is built on the fp16 pipe: each byte, less (2 q, 2 q + 1)
// for the thread's column pair q, as a half2, compared (HSET2: two compares
// an instruction, 1.0 or 0.0, the fragment's own format) with (16 kt, 16
// kt) and (16 kt + 8, 16 kt + 8): 64 compares a thread a step, 128 a string
// (its 256 compares, two an instruction).  Every value is an integer under
// 2048, exact in fp16.
// The two picks of the products:
//   PICK_GATHER: the accumulators [16, 128] of a warp through shared
//                memory (their f32 bits), each row's column s read back
//                and made int32 (the probes' take_along_axis, fullwidth's
//                full-width gather);
//   PICK_SUM:    each thread's accumulators masked by column == s, summed,
//                then summed across the 4 threads of its row (select's
//                one-hot sum).
// Every product is exact: the values are under 256 and each sum has one
// nonzero term, so every form equals the lookup loop bit for bit.
//
// What bounds it on the H100.  LOOKUP: the bytes at a large batch (int32
// bytes in, int32 states out: 0.0802 ms at 32768 x 1024), the chain of
// dependent LDS a step at a small one (the lone chain: 48.5 cycles a step).
// Its design keeps everything but the chain off the chain, as the table
// scan (table_scan.cu) does, and moves bytes and states in whole lines:
//   - one block an SM: T staged once a block by bulk copies (TMA, one
//     mbarrier) straight into shared memory, in flight beside the first
//     byte groups' copies; no conversion: a row is 512 bytes, so a step's
//     address is the row's, computed when the byte arrives, plus 4 s (one
//     LEA);
//   - a warp takes a tile of 32 strings (a lane a string), persistent
//     (warp g tiles g, g + the grid's warps, ...); its bytes and states
//     move as [kLkStep steps x 32 strings] tiles (time-major: 16 rows of
//     128 bytes; batch-major: 32 rows of 64, padded to 80 in shared memory
//     so that a row's 16-byte reads do not conflict) by 16-byte cp.async
//     copies into the warp's ring (kLkRing - 1 groups in flight), and out
//     of a staged tile by 16-byte stores: every warp instruction moves
//     whole lines (whole 64-byte rows batch-major), not 32 scattered
//     pieces;
//   - 4-byte copies and stores where the layout's contiguous extent (TB
//     time-major, LB batch-major) is not a multiple of 4 or a pointer is
//     not 16-byte aligned; T by plain loads where it is not.
// The products: the f16 tensor-core rate (ONEHOT_MMA: 2 x 256 x 128 flops a
// string a step) or the one-hot's 256 compares a string (CLASS_MMA), none
// of it on the state's chain, which is the pick alone.  So a warpgroup
// issues position t's products (the step's wgmmas, asynchronous) and only
// then picks an earlier position from the other of two accumulators, while
// t's products run: ONEHOT_MMA position t - 1; CLASS_MMA, whose step also
// issues t - 1's last product from its landed class sums, t - 2.  Every
// pick reads sums that the step's first wait (wait_group 0) landed: ptxas
// serialises a warpgroup's wgmmas where an accumulator is read after a
// partial wait.  Two warpgroups a block (one block an SM by registers)
// fill each other's gaps (the one-hot's build, the waits).  CLASS_MMA's
// 16 m64n16k16 a step run far under the tensor cores' rate (an m64n16
// wgmma takes about a quarter of an m64n128 one's time, not an eighth):
// they, not its compares, bound it (kernel_ab.py's class_no_products).  Bytes come through a ring
// of cp.async copies (probe_ring.cuh), 8 steps of a warp's strings a
// group, so a step does not wait on device memory; states are staged two
// groups at a time (the pick lags one or two steps) and stored with the
// layout's contiguous axis across lanes.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "probe_ring.cuh"

namespace {

constexpr int NB = 256;    // bytes: rows of T
constexpr int NS = 128;    // states: columns of T
constexpr int KC = 16;     // CLASS_MMA's classes (fewer padded to 16)
constexpr int GROUP = 8;   // steps a ring group (even: position t's sums in acc[t & 1])
constexpr int RING = 8;    // groups (RING - 1 in flight)
constexpr int PROW = NS + 8;  // the pick buffer's row stride (words): conflict-free 64-bit stores

// LOOKUP's geometry: up to lk_warps<TM>() warps a block (one block an SM: T
// takes 128 KiB of its shared memory, the warps' rings the rest), a warp a
// tile of 32 strings, a group kLkStep steps, kLkRing groups in a warp's
// ring (and one staged group of states); a batch-major row of a group
// padded to kLkRow words
constexpr int kLkWarps = 8;  // time-major; batch-major's longer rows fit 6
constexpr int kLkStep = 16;
constexpr int kLkRing = 5;
constexpr int kLkRow = kLkStep + 4;
constexpr int kLkTable = NB * NS * 4;  // T in shared memory, int32
template <bool TM>
__host__ __device__ constexpr int lk_slot_words() {  // a group's words: [16 steps][32] or [32][20]
  return TM ? kLkStep * 32 : 32 * kLkRow;
}
template <bool TM>
__host__ __device__ constexpr int lk_smem(int warps) {
  return kLkTable + 16 + warps * (kLkRing + 1) * lk_slot_words<TM>() * 4;
}
template <bool TM>
__host__ __device__ constexpr int lk_warps() {
  return TM ? kLkWarps : kLkWarps * 3 / 4;
}

enum Form { LOOKUP = 0, ONEHOT_MMA = 1, CLASS_MMA = 2 };
enum Pick { PICK_GATHER = 0, PICK_SUM = 1 };

// the products' operands in shared memory (f16, K-major, SW128): T as
// [128 n][256 k] (four 16 KiB chunks of 64 k); C as [16 n][256 k] (four of
// 2 KiB), then Tk as [128 n][16 k] (rows of 128 bytes, the first 32 used)
constexpr int kTBytes = NS * NB * 2;
constexpr int kCBytes = KC * NB * 2;
constexpr int kTkBytes = NS * 128;

// the product forms' geometry
constexpr int STRINGS = 16;  // a warp's
constexpr int WARPS = 8;     // a block's: 2 warpgroups
constexpr int OBUF = 2;      // groups of states staged (the lagged pick)

template <int FORM>
__host__ __device__ constexpr int table_bytes() {
  return FORM == ONEHOT_MMA ? kTBytes : kCBytes + kTkBytes;
}

template <int FORM, int PICK>
__host__ __device__ constexpr int warp_bytes() {
  return (RING * GROUP + OBUF * GROUP) * STRINGS * 4 + (PICK == PICK_GATHER ? 16 * PROW * 4 : 0);
}

template <int FORM, int PICK>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + table_bytes<FORM>() +  // + the alignment of the operands (the swizzle's period)
         (size_t)WARPS * warp_bytes<FORM, PICK>();
}

// fp16 bits of a small non-negative integer (exact under 2048)
__host__ __device__ constexpr uint32_t f16_bits(int v) {
  int e = 0;
  while (v >> (e + 1)) ++e;
  return v == 0 ? 0u : (uint32_t)(((e + 15) << 10) | ((v << (10 - e)) & 0x3FF));
}

__device__ __forceinline__ uint32_t h2_bits(__half2 h) { return *(uint32_t*)&h; }

// (x == k) on each half of a half2: 1.0 or 0.0 (HSET2)
__device__ __forceinline__ uint32_t eq2(uint32_t x, uint32_t k) {
  uint32_t e;
  asm("set.eq.f16x2.f16x2 %0, %1, %2;\n" : "=r"(e) : "r"(x), "r"(k));
  return e;
}

// a K-major f16 operand [N][K] into shared memory at `dst` (SW128), 8 k a
// 16-byte unit: at(k, n) its value
template <typename At>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, int N, int K, At at) {
  for (int u = threadIdx.x; u < N * (K / 8); u += blockDim.x) {
    const int n = u / (K / 8), k = u % (K / 8) * 8;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __half_as_ushort(__int2half_rn(at(k + 2 * e, n))) |
             (uint32_t)__half_as_ushort(__int2half_rn(at(k + 2 * e + 1, n))) << 16;
    *(uint4*)(dst + hopper::sw128_kmajor(n, k, N)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ------------------------------------------------------------------ LOOKUP

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int lds(uint32_t addr) {
  int v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The lookup: warp g (of the grid's) walks tiles g, g + gridDim.x * W, ...
// of 32 strings, lane l string b0 + l, from s = 0.  Group p is steps
// kLkStep p ..: its 128 16-byte pieces (time-major: 16 rows of 8, a row a
// step; batch-major: 32 rows of 4, a row a string) are copied 4 a lane
// into ring slot p % kLkRing, and the walk's states go to the staged tile
// in the same layout, then out 4 pieces a lane.  vec: 16-byte copies and
// stores (the contiguous extent a multiple of 4, chars and out 16-byte
// aligned), else 4-byte ones; vec_t: T 16-byte aligned (bulk copies).
template <bool TM>
__global__ void __launch_bounds__(lk_warps<TM>() * 32, 1)
dfa_lookup_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ chars,
                  int32_t* __restrict__ out, int TB, int LB, int vec, int vec_t) {
  constexpr int SLOT = lk_slot_words<TM>();
  extern __shared__ __align__(16) unsigned char lk_smem_raw[];
  uint64_t* bar = (uint64_t*)lk_smem_raw;  // T's copies
  const uint32_t tab = hopper::smem_u32(lk_smem_raw + 16);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  int32_t* wbase = (int32_t*)(lk_smem_raw + 16 + kLkTable) + warp * (kLkRing + 1) * SLOT;
  int32_t* staged = wbase + kLkRing * SLOT;  // the group's states
  const int n_groups = (LB + kLkStep - 1) / kLkStep;
  const int n_tiles = (TB + 31) / 32, stride = gridDim.x * W;
  // piece k (0..3) of a lane in a group: its row and its 4 words' offset
  auto piece = [&](int k, int& row, int& col) {
    const int q = lane + 32 * k;
    row = TM ? q / 8 : q / 4;
    col = TM ? 4 * (q % 8) : 4 * (q % 4);
  };
  // where piece (row, col) of group p of the tile from b0 lies: its first
  // element (b, i) and the next elements' direction
  auto at = [&](int b0, int p, int row, int col, int& b, int& i) {
    b = TM ? b0 + col : b0 + row;
    i = TM ? kLkStep * p + row : kLkStep * p + col;
  };
  auto fetch = [&](int b0, int p) {  // an empty group past LB
    if (p < n_groups) {
      int32_t* slot = wbase + (p % kLkRing) * SLOT;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int row, col, b, i;
        piece(k, row, col);
        at(b0, p, row, col, b, i);
        const uint32_t dst = hopper::smem_u32(slot + (TM ? row * 32 : row * kLkRow) + col);
        const int32_t* src = chars + (TM ? (size_t)i * TB + b : (size_t)b * LB + i);
        if (vec) {
          if (b < TB && i < LB) cp16(dst, src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (TM ? (b + e < TB && i < LB) : (b < TB && i + e < LB)) cp4(dst + 4 * e, src + e);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto store = [&](int b0, int p) {  // the staged tile of group p
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int row, col, b, i;
      piece(k, row, col);
      at(b0, p, row, col, b, i);
      const int4 v = *(const int4*)(staged + (TM ? row * 32 : row * kLkRow) + col);
      int32_t* dst = out + (TM ? (size_t)i * TB + b : (size_t)b * LB + i);
      if (vec) {
        if (b < TB && i < LB) *(int4*)dst = v;
      } else {
        const int w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (TM ? (b + e < TB && i < LB) : (b < TB && i + e < LB)) dst[e] = w4[e];
      }
    }
  };

  // T's copies first, then each warp's first kLkRing - 1 groups
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (vec_t) {
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar, kLkTable);
      for (int k = 0; k < 8; ++k)
        hopper::bulk_load(lk_smem_raw + 16 + k * (kLkTable / 8), T + k * (NB * NS / 8),
                          kLkTable / 8, bar);
    }
  } else {
    for (int i = threadIdx.x; i < NB * NS; i += blockDim.x) ((int32_t*)(lk_smem_raw + 16))[i] = T[i];
    __syncthreads();
  }
  int tile = blockIdx.x * W + warp;
  for (int p = 0; p < kLkRing - 1; ++p) fetch(32 * tile, p);
  if (vec_t) hopper::mbar_wait(bar, 0);  // T has landed

  for (; tile < n_tiles; tile += stride) {
    const int b0 = 32 * tile;
    if (tile != blockIdx.x * W + warp)
      for (int p = 0; p < kLkRing - 1; ++p) fetch(b0, p);
    int s = 0;  // the lane's string's state
#pragma unroll 1
    for (int p = 0; p < n_groups; ++p) {
      __syncwarp();                // every lane is done with slot (p - 1) % kLkRing and the staged tile
      fetch(b0, p + kLkRing - 1);  // into slot (p - 1) % kLkRing
      cp_wait<kLkRing - 1>();      // this lane's copies of group p have landed
      __syncwarp();                // and every lane's
      const int32_t* slot = wbase + (p % kLkRing) * SLOT;
#pragma unroll
      for (int j4 = 0; j4 < kLkStep; j4 += 4) {
        int c[4], o[4];
        if (TM) {
#pragma unroll
          for (int j = 0; j < 4; ++j) c[j] = slot[(j4 + j) * 32 + lane];
        } else {
          const int4 v = *(const int4*)(slot + lane * kLkRow + j4);
          c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // the row's shared address, off the chain; then one LEA, one LDS
          const uint32_t row = tab + ((uint32_t)c[j] & 255u) * 512u;
          s = lds(row + ((uint32_t)s << 2));
          o[j] = s;
        }
        if (TM) {
#pragma unroll
          for (int j = 0; j < 4; ++j) staged[(j4 + j) * 32 + lane] = o[j];
        } else {
          *(int4*)(staged + lane * kLkRow + j4) = make_int4(o[0], o[1], o[2], o[3]);
        }
      }
      __syncwarp();  // the staged tile is whole
      store(b0, p);
    }
  }
  cp_wait<0>();
}

template <int FORM, int PICK>
__global__ void __launch_bounds__(WARPS * 32)
dfa_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ classes,
           const int32_t* __restrict__ chars, int32_t* __restrict__ out, int TB, int LB,
           int time_major, int K) {
  constexpr int STR = STRINGS;
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* smem = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  // the table
  if constexpr (FORM == ONEHOT_MMA) {
    stage_kmajor(smem, NS, NB, [&](int k, int n) { return T[k * NS + n]; });
  } else {
    stage_kmajor(smem, KC, NB, [&](int k, int n) { return (int)(classes[k] == n); });
    stage_kmajor(smem + kCBytes, NS, KC, [&](int k, int n) { return k < K ? T[k * NS + n] : 0; });
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + table_bytes<FORM>() + (size_t)w * warp_bytes<FORM, PICK>();
  uint32_t* ring = (uint32_t*)wbase;                       // [RING][GROUP][STR]
  int32_t* obuf = (int32_t*)(ring + RING * GROUP * STR);   // [OBUF][GROUP][STR]
  float* pick = (float*)(obuf + OBUF * GROUP * STR);       // [16][PROW] (PICK_GATHER)
  const int b0 = (blockIdx.x * WARPS + w) * STR;
  // a warp runs while its warpgroup has a string (wgmma is the
  // warpgroup's), its strings past TB unstored
  if ((blockIdx.x * WARPS + (w & ~3)) * STR >= TB) return;
  const size_t sb = time_major ? 1 : (size_t)LB, si = time_major ? (size_t)TB : 1;
  const int n_groups = (LB + GROUP - 1) / GROUP;
  // item q of a group: (string m, step j), the layout's contiguous axis across lanes
  auto item = [&](int q, int& m, int& j) {
    if (time_major) { m = q % STR; j = q / STR; } else { m = q / GROUP; j = q % GROUP; }
  };
  auto fetch = [&](int p) {  // group p's bytes into slot p % RING; an empty group past LB
    if (p < n_groups) {
      for (int q = lane; q < GROUP * STR; q += 32) {
        int m, j;
        item(q, m, j);
        const int b = b0 + m, i = p * GROUP + j;
        if (b < TB && i < LB)
          probe_ring::copy4(&ring[(p % RING) * GROUP * STR + j * STR + m],
                            chars + b * sb + i * si);
      }
    }
    probe_ring::commit();
  };
  auto flush = [&](int p) {  // group p's staged states to out
    __syncwarp();
    const int32_t* ob = obuf + (p % OBUF) * GROUP * STR;
    for (int q = lane; q < GROUP * STR; q += 32) {
      int m, j;
      item(q, m, j);
      const int b = b0 + m, i = p * GROUP + j;
      if (b < TB && i < LB) out[b * sb + i * si] = ob[j * STR + m];
    }
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);

  {
    const uint32_t tab = hopper::smem_u32(smem);
    constexpr int LAG = FORM == ONEHOT_MMA ? 1 : 2;  // steps from a position's bytes to its pick
    const int g = lane >> 2, tig = lane & 3;
    // a byte less (2 tig, 2 tig + 1): equal to (16 kt, 16 kt) where the
    // one-hot is 1 at columns 16 kt + 2 tig + {0, 1} of the k16 slice kt
    const __half2 off = __floats2half2_rn((float)(2 * tig), (float)(2 * tig + 1));
    // position t's sums in acc[t & 1], rows g, g + 8 at [4 j + 2 h + e];
    // CLASS_MMA's class one-hot [64, 16] of the last position issued
    float acc[2][NS / 2], kacc[KC / 2];
    uint32_t a[NB / 16][4], ak[4];  // the A fragments: the one-hot's 16 k16 slices; the classes'
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) acc[0][e] = acc[1][e] = 0.f;
#pragma unroll
    for (int e = 0; e < KC / 2; ++e) kacc[e] = 0.f;
    int s_lo = 0, s_hi = 0;  // rows g and g + 8

    // position t's products, asynchronous, one commit group: the one-hot of
    // the bytes c_lo, c_hi (rows g, g + 8) as A, times T into d
    // (ONEHOT_MMA) or times C into the class sums (CLASS_MMA)
    auto issue = [&](float* d, int c_lo, int c_hi) {
      const uint32_t xl = h2_bits(__hsub2(__half2half2(__int2half_rn(c_lo)), off));
      const uint32_t xh = h2_bits(__hsub2(__half2half2(__int2half_rn(c_hi)), off));
#pragma unroll
      for (int kt = 0; kt < NB / 16; ++kt) {
        const uint32_t k0 = f16_bits(16 * kt) * 0x10001u, k8 = f16_bits(16 * kt + 8) * 0x10001u;
        a[kt][0] = eq2(xl, k0);
        a[kt][1] = eq2(xh, k0);
        a[kt][2] = eq2(xl, k8);
        a[kt][3] = eq2(xh, k8);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < NB / 16; ++kt) {
        if constexpr (FORM == ONEHOT_MMA)
          hopper::wgmma_m64n128k16_f16_rs(
              d, a[kt], hopper::sw128_desc(tab + hopper::sw128_kmajor(0, 16 * kt, NS), 16, 1024),
              kt > 0);
        else
          hopper::wgmma_m64n16k16_f16_rs(
              kacc, a[kt], hopper::sw128_desc(tab + hopper::sw128_kmajor(0, 16 * kt, KC), 16, 1024),
              kt > 0);
      }
      hopper::wgmma_commit();
    };
    // CLASS_MMA's last product into d from landed class sums: as f16 (0.0
    // and 1.0 are exact), they are the k16 A fragment of m64n128k16 by Tk
    auto finish = [&](float* d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) ak[r] = h2_bits(__floats2half2_rn(kacc[2 * r], kacc[2 * r + 1]));
      hopper::wgmma_fence();
      hopper::wgmma_m64n128k16_f16_rs(d, ak, hopper::sw128_desc(tab + kCBytes, 16, 1024), 0);
      hopper::wgmma_commit();
    };
    // position t's states from its sums d: column s_lo of row g, s_hi of row g + 8
    auto pick_step = [&](const float* d, int t) {
      if constexpr (PICK == PICK_GATHER) {  // the sums as f32; the picked one to int32
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int n = j * 8 + tig * 2;
          *(float2*)&pick[g * PROW + n] = make_float2(d[4 * j], d[4 * j + 1]);
          *(float2*)&pick[(g + 8) * PROW + n] = make_float2(d[4 * j + 2], d[4 * j + 3]);
        }
        __syncwarp();
        s_lo = (int)pick[g * PROW + s_lo];
        s_hi = (int)pick[(g + 8) * PROW + s_hi];
        __syncwarp();  // read before the next step's stores
      } else {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          const int n = j * 8 + tig * 2;
          lo += (n == s_lo ? d[4 * j] : 0.f) + (n + 1 == s_lo ? d[4 * j + 1] : 0.f);
          hi += (n == s_hi ? d[4 * j + 2] : 0.f) + (n + 1 == s_hi ? d[4 * j + 3] : 0.f);
        }
        lo += __shfl_xor_sync(0xffffffffu, lo, 1);
        lo += __shfl_xor_sync(0xffffffffu, lo, 2);
        hi += __shfl_xor_sync(0xffffffffu, hi, 1);
        hi += __shfl_xor_sync(0xffffffffu, hi, 2);
        s_lo = (int)lo;
        s_hi = (int)hi;
      }
      if (tig == 0) {
        int32_t* ob = obuf + (t % (2 * GROUP)) * STR;
        ob[g] = s_lo;
        ob[g + 8] = s_hi;
      }
    };
    // the groups committed so far have landed: every operand is free
    auto land = [&]() {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < NS / 2; ++e) {
        hopper::fence_operand(acc[0][e]);
        hopper::fence_operand(acc[1][e]);
      }
      if constexpr (FORM == CLASS_MMA) {
#pragma unroll
        for (int e = 0; e < KC / 2; ++e) hopper::fence_operand(kacc[e]);
      }
#pragma unroll
      for (int kt = 0; kt < NB / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) hopper::fence_operand(a[kt][r]);
    };
    // a step: position t's products are issued before the pick of
    // position t - LAG, which reads sums that landed at the step's start:
    // ONEHOT_MMA's products of t - 1; CLASS_MMA's last product of t - 2
    // (that of t - 1 is issued here, from its landed class sums)
    auto step = [&](int t, int j, const uint32_t* grp) {
      land();
      if (FORM == CLASS_MMA && t >= 1 && t - 1 < LB) finish(acc[(j + 1) & 1]);
      if (t < LB)  // the same for the warpgroup
        issue(acc[j & 1], (int)grp[j * STR + g], (int)grp[j * STR + g + 8]);
      if (t >= LAG && t - LAG < LB) pick_step(acc[(j + LAG) & 1], t - LAG);
    };
#pragma unroll 1
    for (int p = 0; p < n_groups; ++p) {
      __syncwarp();  // every lane is done with slot (p - 1) % RING
      fetch(p + RING - 1);
      probe_ring::wait_oldest<RING>();
      __syncwarp();  // group p's bytes from every lane have landed
      const uint32_t* grp = ring + (p % RING) * GROUP * STR;
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        step(p * GROUP + j, j, grp);
        if (j == LAG - 1 && p > 0) flush(p - 1);  // after its last position's pick
      }
    }
#pragma unroll
    for (int j = 0; j < LAG; ++j) step(n_groups * GROUP + j, j, ring);  // the last picks
    flush(n_groups - 1);
  }
  probe_ring::wait_all();
}

template <int FORM, int PICK>
int launch(const void* T, const void* classes, const void* chars, void* out, int TB, int LB,
           int time_major, int K, cudaStream_t st) {
  auto kern = dfa_kernel<FORM, PICK>;
  const size_t smem = smem_bytes<FORM, PICK>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per_block = WARPS * STRINGS;
  kern<<<(TB + per_block - 1) / per_block, WARPS * 32, smem, st>>>(
      (const int32_t*)T, (const int32_t*)classes, (const int32_t*)chars, (int32_t*)out, TB, LB,
      time_major, K);
  return (int)cudaGetLastError();
}

// the grid: one block an SM (its shared memory), each warp the same number
// of tiles (rounds: the fewest that lk_warps<TM>() warps an SM allow), as
// few warps a block and blocks as that leaves
template <bool TM>
int launch_lookup(const void* T, const void* chars, void* out, int TB, int LB, cudaStream_t st) {
  auto kern = dfa_lookup_kernel<TM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       lk_smem<TM>(lk_warps<TM>()));
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int vec = (TM ? TB : LB) % 4 == 0 && ((uintptr_t)chars | (uintptr_t)out) % 16 == 0;
  const int vec_t = (uintptr_t)T % 16 == 0;
  const int n_tiles = (TB + 31) / 32;
  const int rounds = (n_tiles + sms * lk_warps<TM>() - 1) / (sms * lk_warps<TM>());
  const int warps = (n_tiles + sms * rounds - 1) / (sms * rounds);
  const int blocks = (n_tiles + warps * rounds - 1) / (warps * rounds);
  kern<<<blocks, warps * 32, lk_smem<TM>(warps), st>>>((const int32_t*)T, (const int32_t*)chars,
                                                         (int32_t*)out, TB, LB, vec, vec_t);
  return (int)cudaGetLastError();
}

}  // namespace

// form 0 LOOKUP, 1 ONEHOT_MMA, 2 CLASS_MMA; pick 0 gather, 1 sum (the
// products only); CLASS_MMA reads T as Tk [K, 128] (K <= 16) and classes
// [256] in [0, K); the others T [256, 128] and no classes
extern "C" int h2r_dfa_step(const void* T, const void* classes, const void* chars, void* out,
                            int TB, int LB, int time_major, int form, int pick, int K,
                            void* stream) {
  if (TB <= 0 || LB <= 0 || K < 1 || K > KC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tm = time_major != 0;
  if (form == LOOKUP)
    return tm ? launch_lookup<true>(T, chars, out, TB, LB, st)
              : launch_lookup<false>(T, chars, out, TB, LB, st);
  if (form == ONEHOT_MMA && pick == PICK_GATHER)
    return launch<ONEHOT_MMA, PICK_GATHER>(T, classes, chars, out, TB, LB, tm, K, st);
  if (form == ONEHOT_MMA && pick == PICK_SUM)
    return launch<ONEHOT_MMA, PICK_SUM>(T, classes, chars, out, TB, LB, tm, K, st);
  if (form == CLASS_MMA && pick == PICK_GATHER)
    return launch<CLASS_MMA, PICK_GATHER>(T, classes, chars, out, TB, LB, tm, K, st);
  if (form == CLASS_MMA && pick == PICK_SUM)
    return launch<CLASS_MMA, PICK_SUM>(T, classes, chars, out, TB, LB, tm, K, st);
  return (int)cudaErrorInvalidValue;
}
