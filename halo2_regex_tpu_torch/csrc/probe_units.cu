// nop, onehot_count, int8_mma and class_chain -- four unit probes of tools/
// as H100 kernels (mma_accum is csrc/probe_mma_accum.cu's):
//
// nop replaces probe_tpu2.py's A (knop, pallas_call at :59): o = x + 1 on
// [8, 128] int32 (wrapping), the dispatch cost.  Its time is the launch;
// a thread an element.
//
// onehot_count replaces probe_tpu2.py's F (k4, pallas_call at :247):
// o[0, j] = sum_i sum_k [c[i, j] == k] over k < 256, c [LB, TB] int32
// time-major, o [1, TB] int32: the count of each column's bytes in
// [0, 256), by 256 compares a byte, as the probe builds the one-hot.  The
// keys come from a shared-memory row that the kernel writes and reads
// with volatile 16-byte loads, so nvcc can neither fold the compares into
// a range test nor hold the row in registers: it is the compare rate that
// is measured.  What bounds it: operations (256 compares and their sums a
// byte).  Design: a block owns 32 adjacent columns (a warp reads a
// 128-byte row piece) and a cluster of up to 16 blocks splits the rows;
// each thread holds kCountRows bytes of its column, so one key load serves
// that many independent compare chains.  The compares are on half2: each
// byte converted once to fp16 and duplicated, HSET2 against two keys at
// once (1.0 where equal), HADD2 into the byte's pair of sums.  Every int
// in [-2048, 2048] is exact in fp16 and rounding is monotone, so no other
// int32 becomes a value in 0..255: the count is exact.  The partials go
// through the block's shared memory and then rank 0's (distributed shared
// memory): one writer a column, so the output needs no zero fill and a
// call stays one launch (kernel_ab.py's variants time atomics after a
// fill, and the compares on the int pipe).
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
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void nop_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = (int32_t)((uint32_t)x[i] + 1u);
}

constexpr int kCountWarps = 16;    // a block: 32 columns x 16 warps
constexpr int kCountRows = 4;      // bytes a thread holds, rows kCountWarps apart
constexpr int kCountCluster = 16;  // blocks over the rows (past the portable 8: opted in)

// a 16-byte shared-memory load that nvcc may neither drop nor hoist
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// acc + (h == k) on each half of a half2 (1.0 where equal): HSET2, HADD2
__device__ __forceinline__ uint32_t count2(uint32_t acc, uint32_t h, uint32_t k) {
  uint32_t e;
  asm("set.eq.f16x2.f16x2 %0, %1, %2;\n" : "=r"(e) : "r"(h), "r"(k));
  asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(acc) : "r"(acc), "r"(e));
  return acc;
}

__device__ __forceinline__ uint32_t half2_bits(__half2 h) { return *(uint32_t*)&h; }

// the count of a pair of fp16 sums (each at most 128: exact)
__device__ __forceinline__ int count_of(uint32_t acc) {
  const float2 f = __half22float2(*(__half2*)&acc);
  return (int)(f.x + f.y);
}

// grid: ceil(TB / 32) column tiles x `split` blocks over the rows, a
// cluster of `split`
template <int R>
__global__ void __launch_bounds__(kCountWarps * 32)
onehot_count_kernel(const int32_t* __restrict__ c, int32_t* __restrict__ o, int LB, int TB,
                    int split) {
  __shared__ __align__(16) uint32_t keys[128];  // half2 (2k, 2k + 1)
  __shared__ int part[kCountWarps][32];
  __shared__ int parts[kCountCluster][32];  // rank 0's: every rank's
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % split;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int k = tid; k < 128; k += kCountWarps * 32)
    keys[k] = half2_bits(__halves2half2(__int2half_rn(2 * k), __int2half_rn(2 * k + 1)));
  __syncthreads();
  const int j = (blockIdx.x / split) * 32 + lane;
  const bool col = j < TB;
  constexpr int kStep = kCountWarps * R;
  int total = 0;
#pragma unroll 1
  for (int i0 = rank * kStep; i0 < LB; i0 += split * kStep) {
    uint32_t h[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = i0 + r * kCountWarps + w;
      const __half x = __int2half_rn(col && row < LB ? __ldg(c + (size_t)row * TB + j) : -1);
      h[r] = half2_bits(__halves2half2(x, x));
      acc[r] = 0;
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const uint4 k = lds128(&keys[4 * q]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = count2(acc[r], h[r], k.x);
        acc[r] = count2(acc[r], h[r], k.y);
        acc[r] = count2(acc[r], h[r], k.z);
        acc[r] = count2(acc[r], h[r], k.w);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) total += count_of(acc[r]);
  }
  part[w][lane] = total;
  __syncthreads();
  int sum = 0;
  if (tid < 32) {
#pragma unroll
    for (int k = 0; k < kCountWarps; ++k) sum += part[k][tid];
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < 32) cluster.map_shared_rank(&parts[0][0], 0)[rank * 32 + tid] = sum;
  cluster.sync();  // every rank's partial is in rank 0's memory
  if (rank == 0 && tid < 32 && col) {
    int all = 0;
#pragma unroll
    for (int r = 0; r < kCountCluster; ++r)
      if (r < split) all += parts[r][tid];
    o[j] = all;
  }
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
  constexpr int kStep = kCountWarps * kCountRows;
  const int groups = max(1, LB / kStep + (LB % kStep != 0));
  const int split = min(kCountCluster, groups);
  auto kernel = onehot_count_kernel<kCountRows>;
  if (kCountCluster > 8) {  // past the portable cluster size
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((TB + 31) / 32 * split);
  cfg.blockDim = dim3(kCountWarps * 32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)c, (int32_t*)o, LB, TB, split);
  if (err != cudaSuccess) return (int)err;
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
