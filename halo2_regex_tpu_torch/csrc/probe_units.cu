// nop, onehot_count, int8_mma, mma_accum and class_chain -- five unit
// probes of tools/ as H100 kernels:
//
// nop replaces probe_tpu2.py's A (knop, pallas_call at :59): o = x + 1 on
// [8, 128] int32 (wrapping), the dispatch cost.  Its time is the launch;
// a thread an element.
//
// onehot_count replaces probe_tpu2.py's F (k4, pallas_call at :247):
// o[0, j] = sum_i sum_k [c[i, j] == k] over k < 256, c [LB, TB] int32
// time-major, o [1, TB] int32: the count of each column's bytes in
// [0, 256), by 256 compares a byte, as the probe builds the one-hot.  The
// compare values come from a shared-memory row that the kernel writes, so
// nvcc cannot fold the compares into a range test: it is the compare
// rate that is measured.  What bounds it: operations (256 compares and
// adds a byte, and the 64 16-byte loads of the row), a thread a column.
//
// int8_mma replaces probe_tpu17.py's k (pallas_call at :83): c = a @ b in
// int32 of int8 a [M, K] and b [K, N], row-major.  mma.sync.m16n8k32
// s8 x s8 -> s32.  A block of 4 warps owns a 64 x 64 tile of c and walks K
// 32 at a time through shared memory (a as [m][k], b transposed to [n][k]
// so each fragment register is one 32-bit load); a warp owns 16 rows x 64
// columns, 8 mma.sync a k-step.  What bounds it: the int8 tensor-core
// rate at 128^3 and 4096^3 only in principle; this first form loads its
// tiles with no double buffering, so its loads and barriers are exposed.
// Sums wrap in int32 (exact while K * 128 * 128 < 2^31).
//
// mma_accum replaces probe_tpu21.py's D (mm_kern :97, pallas_call at :112)
// and probe_tpu20.py's D (mm_kern :211, pallas_call at :226, whose block
// shapes make it raise; probe_tpu21 corrected them): out[i, l] = sum over
// l' <= l of a[i, l'] @ b[i, l'], bf16 a [NI, NL, M, K] and b [NI, NL, K,
// N], f32 out [NI, NL, M, N], the accumulator carried over l (the probe's
// second grid axis, its scratch).  The TPU carried the sum across grid
// steps in VMEM scratch; here a block owns one 64 x 64 tile of one i,
// loops over l itself and keeps its f32 accumulators in registers across
// l, storing each l's running sum.  mma.sync.m16n8k16 bf16 x bf16 -> f32,
// 4 warps of 16 rows x 64 columns, K 32 a step through shared memory (a as
// [m][k], b transposed to [n][k], rows padded to 40 halves: each fragment
// register one conflict-free 32-bit load), as int8_mma does.  What bounds
// it: at the probe's [4, 2, 128, 128] a launch; at large tiles the bf16
// tensor-core rate in principle, but this first form has no double
// buffering, so its loads and barriers are exposed.  The products of bf16
// values are exact in f32; the sums are exact for integer values under
// 2^24, and otherwise differ from a sequential f32 sum by rounding.
//
// class_chain replaces probe_tpu6.py's k4 (:174, pallas_call at :186): a
// byte's class as a chain of compares, cls = sum_t delta_t * (c >= b_t)
// over up to 32 (b_t, delta_t) terms, elementwise on c int32.  Two forms:
// CHAIN, the compares of every term unrolled (the terms are a launch
// argument, so they sit in the constant bank), and TABLE, the chain
// evaluated once for each of the 256 bytes into shared memory, then one
// lookup an element, at the byte clamped to [0, 255] (equal to the chain
// for every c when every b_t lies in [1, 255], which the wrapper checks).
// What bounds it: bytes (an int32 read and written an element), 16-byte
// accesses, four elements a thread; at the probe's [64, 128] a launch.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void nop_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int32_t)((uint32_t)x[i] + 1u);
}

constexpr int COUNT_THREADS = 128;

__global__ void __launch_bounds__(COUNT_THREADS)
onehot_count_kernel(const int32_t* __restrict__ c, int32_t* __restrict__ o, int LB, int TB) {
  __shared__ int4 keys[64];  // 0..255, written here
  for (int i = threadIdx.x; i < 256; i += COUNT_THREADS) ((int*)keys)[i] = i;
  __syncthreads();
  const int j = blockIdx.x * COUNT_THREADS + threadIdx.x;
  if (j >= TB) return;
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < LB; ++i) {
    const int v = c[(size_t)i * TB + j];
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      const int4 k = keys[q];
      acc += (uint32_t)(v == k.x) + (uint32_t)(v == k.y) + (uint32_t)(v == k.z) +
             (uint32_t)(v == k.w);
    }
  }
  o[j] = (int32_t)acc;
}

constexpr int MM_WARPS = 4;
constexpr int TILE = 64;   // c's tile: TILE x TILE
constexpr int KSTEP = 32;  // k a step: one m16n8k32
constexpr int KS = 48;     // shared row stride (bytes): conflict-free fragment loads

__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(MM_WARPS * 32)
int8_mma_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                int32_t* __restrict__ c, int M, int N, int K, int full) {
  __shared__ __align__(16) int8_t as[TILE * KS];  // [m][k]
  __shared__ __align__(16) int8_t bs[TILE * KS];  // [n][k]
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  int acc[TILE / 8][4] = {};
  for (int k0 = 0; k0 < K; k0 += KSTEP) {
    {  // a: row t / 2, 16 bytes at k (t & 1) * 16
      const int r = t >> 1, kk = (t & 1) * 16;
      int8_t* dst = &as[r * KS + kk];
      if (full) {
        *(int4*)dst = *(const int4*)&a[(size_t)(m0 + r) * K + k0 + kk];
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int k = k0 + kk + e;
          dst[e] = (m0 + r < M && k < K) ? a[(size_t)(m0 + r) * K + k] : (int8_t)0;
        }
      }
    }
    {  // b: row k t / 4, 16 bytes at n (t & 3) * 16, written transposed
      const int kk = t >> 2, nn = (t & 3) * 16, k = k0 + kk;
      __align__(16) int8_t v[16];
      if (full) {
        *(int4*)v = *(const int4*)&b[(size_t)k * N + n0 + nn];
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = (k < K && n0 + nn + e < N) ? b[(size_t)k * N + n0 + nn + e] : (int8_t)0;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) bs[(nn + e) * KS + kk] = v[e];
    }
    __syncthreads();
    const int r = w * 16 + g;
    const uint32_t a0 = *(const uint32_t*)&as[r * KS + tig * 4];
    const uint32_t a1 = *(const uint32_t*)&as[(r + 8) * KS + tig * 4];
    const uint32_t a2 = *(const uint32_t*)&as[r * KS + 16 + tig * 4];
    const uint32_t a3 = *(const uint32_t*)&as[(r + 8) * KS + 16 + tig * 4];
#pragma unroll
    for (int nt = 0; nt < TILE / 8; ++nt) {
      const int n = nt * 8 + g;
      const uint32_t b0 = *(const uint32_t*)&bs[n * KS + tig * 4];
      const uint32_t b1 = *(const uint32_t*)&bs[n * KS + 16 + tig * 4];
      mma_s8(acc[nt], a0, a1, a2, a3, b0, b1);
    }
    __syncthreads();
  }
  const int r = m0 + w * 16 + g;
#pragma unroll
  for (int nt = 0; nt < TILE / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + (e >> 1) * 8, col = n0 + nt * 8 + tig * 2 + (e & 1);
      if (row < M && col < N) c[(size_t)row * N + col] = acc[nt][e];
    }
  }
}

constexpr int ACC_WARPS = 4;
constexpr int ACC_TILE = 64;  // out's tile: ACC_TILE x ACC_TILE
constexpr int ACC_KSTEP = 32;  // k a step: two m16n8k16
constexpr int AKS = ACC_KSTEP + 8;  // shared row stride (halves): conflict-free fragment loads

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (N / 64, M / 64, NI); M and N multiples of 64, K of 32, a and b
// 16-byte aligned (the wrapper checks)
__global__ void __launch_bounds__(ACC_WARPS * 32)
mma_accum_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                 float* __restrict__ c, int NL, int M, int N, int K) {
  __shared__ __align__(16) uint16_t as[ACC_TILE * AKS];  // [m][k]
  __shared__ __align__(16) uint16_t bs[ACC_TILE * AKS];  // [n][k]
  const int t = threadIdx.x, w = t >> 5, lane = t & 31, g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * ACC_TILE, m0 = blockIdx.y * ACC_TILE, i = blockIdx.z;
  float acc[ACC_TILE / 8][4] = {};
  const int r = w * 16 + g;
#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
    const uint16_t* A = a + ((size_t)i * NL + l) * M * K;
    const uint16_t* B = b + ((size_t)i * NL + l) * K * N;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += ACC_KSTEP) {
#pragma unroll
      for (int e = t; e < ACC_TILE * ACC_KSTEP / 8; e += ACC_WARPS * 32) {
        // a: row e / 4, 8 halves at k (e % 4) * 8
        const int ra = e >> 2, ka = (e & 3) * 8;
        *(int4*)&as[ra * AKS + ka] = *(const int4*)&A[(size_t)(m0 + ra) * K + k0 + ka];
        // b: row k e / 8, 8 halves at n (e % 8) * 8, written transposed
        const int kb = e >> 3, nb = (e & 7) * 8;
        const int4 v = *(const int4*)&B[(size_t)(k0 + kb) * N + n0 + nb];
        const uint16_t* h = (const uint16_t*)&v;
#pragma unroll
        for (int q = 0; q < 8; ++q) bs[(nb + q) * AKS + kb] = h[q];
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < ACC_KSTEP; ks += 16) {
        const uint32_t a0 = *(const uint32_t*)&as[r * AKS + ks + tig * 2];
        const uint32_t a1 = *(const uint32_t*)&as[(r + 8) * AKS + ks + tig * 2];
        const uint32_t a2 = *(const uint32_t*)&as[r * AKS + ks + 8 + tig * 2];
        const uint32_t a3 = *(const uint32_t*)&as[(r + 8) * AKS + ks + 8 + tig * 2];
#pragma unroll
        for (int nt = 0; nt < ACC_TILE / 8; ++nt) {
          const int n = nt * 8 + g;
          const uint32_t b0 = *(const uint32_t*)&bs[n * AKS + ks + tig * 2];
          const uint32_t b1 = *(const uint32_t*)&bs[n * AKS + ks + 8 + tig * 2];
          mma_bf16(acc[nt], a0, a1, a2, a3, b0, b1);
        }
      }
      __syncthreads();
    }
    // l's running sum
    float* C = c + ((size_t)i * NL + l) * M * N;
#pragma unroll
    for (int nt = 0; nt < ACC_TILE / 8; ++nt) {
      const int col = n0 + nt * 8 + tig * 2;
      *(float2*)&C[(size_t)(m0 + r) * N + col] = make_float2(acc[nt][0], acc[nt][1]);
      *(float2*)&C[(size_t)(m0 + r + 8) * N + col] = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

constexpr int MAX_TERMS = 32;
constexpr int CHAIN_THREADS = 256;

struct Terms {
  int n;
  int b[MAX_TERMS];
  int d[MAX_TERMS];
};

__device__ __forceinline__ int chain_class(int v, const Terms& t) {
  int acc = 0;
#pragma unroll
  for (int k = 0; k < MAX_TERMS; ++k)
    if (k < t.n) acc += v >= t.b[k] ? t.d[k] : 0;
  return acc;
}

// form 0 CHAIN, 1 TABLE; c and o 16-byte aligned (the wrapper checks)
__global__ void __launch_bounds__(CHAIN_THREADS)
class_chain_kernel(const int32_t* __restrict__ c, int32_t* __restrict__ o, long long n,
                   const Terms terms, int form) {
  __shared__ int tab[256];
  if (form == 1) {
    for (int i = threadIdx.x; i < 256; i += CHAIN_THREADS) tab[i] = chain_class(i, terms);
    __syncthreads();
  }
  auto cls = [&](int v) { return form == 1 ? tab[min(max(v, 0), 255)] : chain_class(v, terms); };
  const long long n4 = n / 4, stride = (long long)gridDim.x * CHAIN_THREADS;
  for (long long q = (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x; q < n4; q += stride) {
    const int4 v = ((const int4*)c)[q];
    ((int4*)o)[q] = make_int4(cls(v.x), cls(v.y), cls(v.z), cls(v.w));
  }
  for (long long q = n4 * 4 + (long long)blockIdx.x * CHAIN_THREADS + threadIdx.x; q < n;
       q += stride)
    o[q] = cls(c[q]);
}

}  // namespace

extern "C" int h2r_nop(const void* x, void* o, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  nop_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)o,
                                                                 n);
  return (int)cudaGetLastError();
}

extern "C" int h2r_onehot_count(const void* c, void* o, int LB, int TB, void* stream) {
  if (LB < 0 || TB <= 0) return (int)cudaErrorInvalidValue;
  onehot_count_kernel<<<(TB + COUNT_THREADS - 1) / COUNT_THREADS, COUNT_THREADS, 0,
                        (cudaStream_t)stream>>>((const int32_t*)c, (int32_t*)o, LB, TB);
  return (int)cudaGetLastError();
}

extern "C" int h2r_int8_mma(const void* a, const void* b, void* c, int M, int N, int K,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int full = M % TILE == 0 && N % TILE == 0 && K % KSTEP == 0 &&
                   ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  int8_mma_kernel<<<grid, MM_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int32_t*)c, M, N, K, full);
  return (int)cudaGetLastError();
}

extern "C" int h2r_mma_accum(const void* a, const void* b, void* c, int NI, int NL, int M, int N,
                             int K, void* stream) {
  if (NI <= 0 || NI > 65535 || NL <= 0 || M <= 0 || N <= 0 || K <= 0 || M % ACC_TILE ||
      N % ACC_TILE || K % ACC_KSTEP || M / ACC_TILE > 65535 ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / ACC_TILE, M / ACC_TILE, NI);
  mma_accum_kernel<<<grid, ACC_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)b, (float*)c, NL, M, N, K);
  return (int)cudaGetLastError();
}

// the terms' thresholds and deltas are host ints (n_terms of each)
extern "C" int h2r_class_chain(const void* c, void* o, long long n, const int* tb, const int* td,
                               int n_terms, int form, void* stream) {
  if (n <= 0 || n_terms < 0 || n_terms > MAX_TERMS || (form != 0 && form != 1) ||
      ((uintptr_t)c | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  Terms t{};
  t.n = n_terms;
  for (int k = 0; k < n_terms; ++k) {
    t.b[k] = tb[k];
    t.d[k] = td[k];
  }
  const long long work = (n + 3) / 4;
  const int blocks = (int)std::min<long long>((work + CHAIN_THREADS - 1) / CHAIN_THREADS, 132 * 16);
  class_chain_kernel<<<blocks, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)c, (int32_t*)o, n, t, form);
  return (int)cudaGetLastError();
}
