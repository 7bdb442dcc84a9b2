// dfa_step -- the DFA-step probes of tools/ as one H100 kernel, three step
// forms as template instances: probe_tpu.py's k6 (pallas_call at :180,
// one-hot product) and k7 (:224, lookup), probe_tpu2.py's C (k, :118,
// one-hot product) and D (k2, :169, class-factored product), and
// probe_tpu3.py's make_scan_fullwidth and make_scan_select (vmem_call,
// :47).
//
// The function: the DFA scan s <- T[c, s] from s = 0, every state written:
// T [256, 128] with values in [0, 128), bytes in [0, 256), batch-major
// [TB, LB] or time-major [LB, TB], out the same layout, int32.  The forms:
//   LOOKUP:     T in shared memory as bytes (32 KiB; its values fit one),
//               one thread a string, s = T[c, s] by one LDS (k7).
//   ONEHOT_MMA: a warp takes 16 strings; each step forms the one-hot of
//               their 16 bytes as bf16 A fragments and multiplies it by
//               the whole T (bf16 B fragments in shared memory, 64 KiB)
//               with mma.sync.m16n8k16 and fp32 accumulators: 16 k-tiles x
//               16 n-tiles, the probe's whole K = 256 x N = 128 (k6, C,
//               fullwidth, select).  Then it picks column s of each row.
//   CLASS_MMA:  the same warp and one-hot, then two products: onehot(c) @
//               C, C [256, 16] the one-hot of the byte classes, whose fp32
//               sums are the bf16 class one-hot as A fragments (an
//               accumulator of m16n8 is an A fragment of m16n8k16), then
//               @ Tk [16, 128] (D): T = Tk[classes].
// The two picks of the products:
//   PICK_GATHER: the accumulators [16, 128] as int32 through shared
//                memory, each row's column s read back (the probes'
//                take_along_axis, fullwidth's full-width gather);
//   PICK_SUM:    each thread's accumulators masked by column == s, summed,
//                then summed across the 4 threads of its row (select's
//                one-hot sum).
// Every product is exact: the values are under 256 and each sum has one
// nonzero term, so every form equals the lookup loop bit for bit.
//
// What bounds it on the H100.  LOOKUP: the chain of dependent LDS a step,
// or the bytes at a large batch (int32 bytes in, int32 states out).  The
// products: 256 (ONEHOT_MMA) or 48 (CLASS_MMA) mma.sync a warp-step and
// the B fragments they read from shared memory (256 B each), none of it
// on the state's chain, which is the pick alone.  Bytes come through a
// ring of cp.async copies (probe_ring.cuh), 8 steps of a warp's strings a
// group, so a step does not wait on device memory; states are staged a
// group at a time and stored with the layout's contiguous axis across
// lanes.  Blocks of 4 warps share the table.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace {

constexpr int NB = 256;    // bytes: rows of T
constexpr int NS = 128;    // states: columns of T
constexpr int KC = 16;     // CLASS_MMA's classes (fewer padded to 16)
constexpr int WARPS = 4;   // a block
constexpr int GROUP = 8;   // steps a ring group
constexpr int RING = 8;    // groups (RING - 1 in flight)
constexpr int PROW = NS + 8;  // the pick buffer's row stride (words): conflict-free 64-bit stores

enum Form { LOOKUP = 0, ONEHOT_MMA = 1, CLASS_MMA = 2 };
enum Pick { PICK_GATHER = 0, PICK_SUM = 1 };

constexpr uint32_t BF16_ONE = 0x3F80u;

// bf16 bits of a small integer (exact: < 2^8 fits its mantissa)
__device__ __forceinline__ uint32_t bf16_int(int v) {
  return __float_as_uint((float)v) >> 16;
}

// a pair of bf16 one-hot values: (c == k) low, (c == k + 1) high
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

template <int FORM>
struct Geo {
  static constexpr int STRINGS = FORM == LOOKUP ? 32 : 16;  // a warp's
  static constexpr int TABLE = FORM == LOOKUP ? NB * NS                     // bytes
                               : FORM == ONEHOT_MMA ? NB / 16 * NS / 8 * 32 * 8
                                                    : (NB / 16 * KC / 8 + NS / 8) * 32 * 8;
};

template <int FORM, int PICK>
__host__ __device__ constexpr int warp_bytes() {
  return (RING * GROUP + GROUP) * Geo<FORM>::STRINGS * 4 +
         (FORM != LOOKUP && PICK == PICK_GATHER ? 16 * PROW * 4 : 0);
}

template <int FORM, int PICK>
__host__ __device__ constexpr size_t smem_bytes() {
  return Geo<FORM>::TABLE + (size_t)WARPS * warp_bytes<FORM, PICK>();
}

// B fragment (m16n8k16, bf16) of a [K, N] matrix at k-tile kt, n-tile nt
// for lane l: rows kt*16 + (l&3)*2 + {0, 1} and + 8, column nt*8 + l/4
template <typename At>
__device__ __forceinline__ uint2 bfrag(At at, int kt, int nt, int l) {
  const int k = kt * 16 + (l & 3) * 2, n = nt * 8 + (l >> 2);
  return make_uint2(bf16_int(at(k, n)) | bf16_int(at(k + 1, n)) << 16,
                    bf16_int(at(k + 8, n)) | bf16_int(at(k + 9, n)) << 16);
}

template <int FORM, int PICK>
__global__ void __launch_bounds__(WARPS * 32)
dfa_kernel(const int32_t* __restrict__ T, const int32_t* __restrict__ classes,
           const int32_t* __restrict__ chars, int32_t* __restrict__ out, int TB, int LB,
           int time_major, int K) {
  constexpr int STR = Geo<FORM>::STRINGS;
  extern __shared__ __align__(16) unsigned char smem[];
  // the table
  if constexpr (FORM == LOOKUP) {
    uint8_t* t8 = smem;
    for (int i = threadIdx.x; i < NB * NS; i += blockDim.x) t8[i] = (uint8_t)T[i];
  } else if constexpr (FORM == ONEHOT_MMA) {
    uint2* bt = (uint2*)smem;  // [16 kt][16 nt][32 lanes]
    auto at = [&](int k, int n) { return T[k * NS + n]; };
    for (int i = threadIdx.x; i < 16 * 16 * 32; i += blockDim.x)
      bt[i] = bfrag(at, i / (16 * 32), i / 32 % 16, i % 32);
  } else {
    uint2* bc = (uint2*)smem;            // C: [16 kt][2 nt][32 lanes]
    uint2* bk = bc + 16 * 2 * 32;        // Tk: [16 nt][32 lanes]
    auto atc = [&](int k, int n) { return (int)(classes[k] == n); };
    auto atk = [&](int k, int n) { return k < K ? T[k * NS + n] : 0; };
    for (int i = threadIdx.x; i < 16 * 2 * 32; i += blockDim.x)
      bc[i] = bfrag(atc, i / 64, i / 32 % 2, i % 32);
    for (int i = threadIdx.x; i < 16 * 32; i += blockDim.x) bk[i] = bfrag(atk, 0, i / 32, i % 32);
  }
  __syncthreads();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + Geo<FORM>::TABLE + (size_t)w * warp_bytes<FORM, PICK>();
  uint32_t* ring = (uint32_t*)wbase;                   // [RING][GROUP][STR]
  int32_t* obuf = (int32_t*)(ring + RING * GROUP * STR);  // [GROUP][STR]
  int32_t* pick = obuf + GROUP * STR;                   // [16][PROW] (PICK_GATHER)
  const int b0 = (blockIdx.x * WARPS + w) * STR;
  if (b0 >= TB) return;
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
  for (int p = 0; p < RING - 1; ++p) fetch(p);

  const int g = lane >> 2, tig = lane & 3;
  int s = 0, s_lo = 0, s_hi = 0;  // LOOKUP: lane's string; the products: rows g and g + 8
#pragma unroll 1
  for (int p = 0; p < n_groups; ++p) {
    __syncwarp();  // every lane is done with slot (p - 1) % RING
    fetch(p + RING - 1);
    probe_ring::wait_oldest<RING>();
    __syncwarp();  // group p's bytes from every lane have landed
    const uint32_t* grp = ring + (p % RING) * GROUP * STR;
    if constexpr (FORM == LOOKUP) {
      const uint8_t* t8 = smem;
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        s = t8[(grp[j * STR + lane] & 255) * NS + s];
        obuf[j * STR + lane] = s;
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < GROUP; ++j) {
        const int c0 = (int)grp[j * STR + g], c1 = (int)grp[j * STR + g + 8];
        float acc[NS / 8][4];
#pragma unroll
        for (int nt = 0; nt < NS / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        if constexpr (FORM == ONEHOT_MMA) {
          const uint2* bt = (const uint2*)smem;
#pragma unroll
          for (int kt = 0; kt < NB / 16; ++kt) {
            const int k = kt * 16 + tig * 2;
            const uint32_t a0 = onehot2(c0, k), a1 = onehot2(c1, k), a2 = onehot2(c0, k + 8),
                           a3 = onehot2(c1, k + 8);
#pragma unroll
            for (int nt = 0; nt < NS / 8; ++nt) {
              const uint2 b = bt[(kt * 16 + nt) * 32 + lane];
              mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
            }
          }
        } else {
          const uint2* bc = (const uint2*)smem;
          const uint2* bk = bc + 16 * 2 * 32;
          float kacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kt = 0; kt < NB / 16; ++kt) {
            const int k = kt * 16 + tig * 2;
            const uint32_t a0 = onehot2(c0, k), a1 = onehot2(c1, k), a2 = onehot2(c0, k + 8),
                           a3 = onehot2(c1, k + 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint2 b = bc[(kt * 2 + nt) * 32 + lane];
              mma_bf16(kacc[nt], a0, a1, a2, a3, b.x, b.y);
            }
          }
          // the class one-hot [16, 16] as an A fragment: 0.0 and 1.0 are exact in bf16
          auto h = [](float x) { return __float_as_uint(x) >> 16; };
          const uint32_t a0 = h(kacc[0][0]) | h(kacc[0][1]) << 16;
          const uint32_t a1 = h(kacc[0][2]) | h(kacc[0][3]) << 16;
          const uint32_t a2 = h(kacc[1][0]) | h(kacc[1][1]) << 16;
          const uint32_t a3 = h(kacc[1][2]) | h(kacc[1][3]) << 16;
#pragma unroll
          for (int nt = 0; nt < NS / 8; ++nt) {
            const uint2 b = bk[nt * 32 + lane];
            mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
          }
        }
        // the pick: column s_lo of row g, s_hi of row g + 8
        if constexpr (PICK == PICK_GATHER) {
#pragma unroll
          for (int nt = 0; nt < NS / 8; ++nt) {
            const int n = nt * 8 + tig * 2;
            *(int2*)&pick[g * PROW + n] = make_int2((int)acc[nt][0], (int)acc[nt][1]);
            *(int2*)&pick[(g + 8) * PROW + n] = make_int2((int)acc[nt][2], (int)acc[nt][3]);
          }
          __syncwarp();
          s_lo = pick[g * PROW + s_lo];
          s_hi = pick[(g + 8) * PROW + s_hi];
          __syncwarp();  // read before the next step's stores
        } else {
          float lo = 0.f, hi = 0.f;
#pragma unroll
          for (int nt = 0; nt < NS / 8; ++nt) {
            const int n = nt * 8 + tig * 2;
            lo += (n == s_lo ? acc[nt][0] : 0.f) + (n + 1 == s_lo ? acc[nt][1] : 0.f);
            hi += (n == s_hi ? acc[nt][2] : 0.f) + (n + 1 == s_hi ? acc[nt][3] : 0.f);
          }
          lo += __shfl_xor_sync(0xffffffffu, lo, 1);
          lo += __shfl_xor_sync(0xffffffffu, lo, 2);
          hi += __shfl_xor_sync(0xffffffffu, hi, 1);
          hi += __shfl_xor_sync(0xffffffffu, hi, 2);
          s_lo = (int)lo;
          s_hi = (int)hi;
        }
        if (tig == 0) {
          obuf[j * STR + g] = s_lo;
          obuf[j * STR + g + 8] = s_hi;
        }
      }
    }
    __syncwarp();  // the group's states are staged
    for (int q = lane; q < GROUP * STR; q += 32) {
      int m, j;
      item(q, m, j);
      const int b = b0 + m, i = p * GROUP + j;
      if (b < TB && i < LB) out[b * sb + i * si] = obuf[j * STR + m];
    }
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
  const int per_block = WARPS * Geo<FORM>::STRINGS;
  kern<<<(TB + per_block - 1) / per_block, WARPS * 32, smem, st>>>(
      (const int32_t*)T, (const int32_t*)classes, (const int32_t*)chars, (int32_t*)out, TB, LB,
      time_major, K);
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
  if (form == LOOKUP) return launch<LOOKUP, PICK_GATHER>(T, classes, chars, out, TB, LB, tm, K, st);
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
