// nop, onehot_count and class_chain -- three unit probes of tools/ as H100
// kernels (mma_accum is csrc/probe_mma_accum.cu's, int8_mma
// csrc/probe_int8_mma.cu's):
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
