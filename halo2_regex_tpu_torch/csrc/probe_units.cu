// nop, onehot_count and int8_mma -- three unit probes of tools/ as H100
// kernels:
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
