// int8_mma -- probe_tpu17.py's k (pallas_call at :83) on int8 wgmma and
// TMA: c = a @ b in int32 of int8 a [M, K] and b [K, N], both row-major,
// c [M, N] int32 (the probe's dot_general with preferred_element_type
// int32).
//
// wgmma multiplies int8 only with both operands K-major, and b is N-major.
// So a call is two launches:
// - the staging pass writes b^T [N, Kp] (Kp: K rounded up to 16, zeros
//   past K) into the caller's scratch, 64 x 64-byte tiles through shared
//   memory, 4 x 4 byte transposes by byte permutes; where TMA cannot read
//   a as it is (K not a multiple of 16, or a not 16-byte aligned) the same
//   launch also copies a into [M, Kp] there.  At 4096^2 it moves 16 MB in
//   and 16 MB out.  Transposing in the product kernel instead would redo
//   it for every row tile of c (32 times at 4096^3), through the shared
//   memory that wgmma reads;
// - the product kernel, warp-specialised as mma_accum
//   (csrc/probe_mma_accum.cu): warpgroup 0's first thread keeps a ring of
//   stages in flight by TMA (3 of 48 KiB for 128 x 256 tiles, taken where N
//   > 128, else 4 of 32 KiB for 128 x 128), each a [128 m x 128 k] box of
//   a and a [BN n x 128 k] box of b^T, both under the 128-byte swizzle;
//   full and empty mbarriers a stage (its loads wait for the staging
//   pass, which lets it launch early: programmatic dependent launch, so
//   its launch and set-up overlap the pass); warpgroups 1 and 2 run wgmma
//   m64nBNk32 s8 x s8 -> s32 on 64 rows each, four a stage, one commit
//   group kept in flight, the sums in registers.  The grid is persistent
//   (one block an SM, each walking tiles blockIdx.x, + gridDim.x, ...), so
//   a tile's epilogue overlaps the producer's loads of the next tile: the
//   sums go through swizzled shared memory and out by TMA stores of
//   [64 x 32] boxes, drained (bulk_wait_read) only when the staging is
//   next written.  Where N is not a multiple of 4 (c's rows are then not
//   16-byte strided for TMA) each thread stores its sums itself.
// The tensor maps zero-fill boxes past M, N and Kp and clip the stores, so
// every shape runs.  What bounds it: the int8 tensor-core rate at 4096^3
// (2 n^3 ops over 1979 TOP/s: 0.0694 ms; c's 64 MB of stores 0.024 ms at
// the card's copy rate, overlapped); at 128^3 the two launches.  Sums wrap
// in int32 (exact while K * 128 * 128 < 2^31: the wrapper's MAX_K).

#include <cstdint>
#include <cuda_runtime.h>

#include "bitplane_common.cuh"  // h2r_bytes4x4
#include "hopper_mma.cuh"

namespace {

constexpr int kPad = 16;  // K rounded up to this in the staged copies (TMA strides)

// ----------------------------------------------------------- staging pass

constexpr int kST = 64;  // a staging tile: 64 k x 64 n bytes of b

__host__ __device__ inline int padded_k(int K) { return (K + kPad - 1) / kPad * kPad; }

// whether TMA reads a in place: 16-byte aligned rows (K % 16) at an aligned base
inline bool a_in_place(const void* a, int K) { return K % kPad == 0 && (uintptr_t)a % 16 == 0; }

// blocks [0, tb) transpose b's 64 x 64 tiles into bt [N, Kp]; blocks
// [tb, ...) copy a into ap [M, Kp] (16 bytes a thread), zeros past K
__global__ void __launch_bounds__(256)
int8_stage_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                  int8_t* __restrict__ bt, int8_t* __restrict__ ap, int M, int N, int K, int tb) {
  __shared__ uint32_t tile[kST][kST / 4 + 1];  // [k][4 n a word], padded: 2-way conflicts at most
  const int Kp = padded_k(K), t = threadIdx.x;
  // the product kernel may launch now: its producer waits for this grid
  // (griddepcontrol.wait) before its first load
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if ((int)blockIdx.x >= tb) {  // a's copy
    const long long q = (long long)(blockIdx.x - tb) * 256 + t, units = (long long)M * (Kp / 16);
    if (q >= units) return;
    const int m = (int)(q / (Kp / 16)), k0 = (int)(q % (Kp / 16)) * 16;
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (k0 + e < K) w[e / 4] |= (uint32_t)(uint8_t)a[(size_t)m * K + k0 + e] << (8 * (e % 4));
    *(uint4*)(ap + (size_t)m * Kp + k0) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  const int nt = (N + kST - 1) / kST;
  const int n0 = (blockIdx.x % nt) * kST, k0 = (blockIdx.x / nt) * kST;
  {  // row k0 + t / 4 of b, 16 bytes at n0 + (t % 4) * 16; zeros outside
    const int k = k0 + t / 4, n = n0 + (t % 4) * 16;
    const int8_t* src = b + (size_t)k * N + n;
    uint32_t w[4] = {0, 0, 0, 0};
    if (k < K && n + 16 <= N && (uintptr_t)src % 16 == 0) {
      const uint4 v = *(const uint4*)src;
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if (k < K) {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (n + e < N) w[e / 4] |= (uint32_t)(uint8_t)src[e] << (8 * (e % 4));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[t / 4][(t % 4) * 4 + e] = w[e];
  }
  __syncthreads();
  {  // 4 k x 4 n bytes a thread: rows n0 + 4 nq + j of bt, bytes k0 + 4 kq ..
    const int kq = t % 16, nq = t / 16;
    uint32_t v[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = tile[4 * kq + i][nq];
    h2r_bytes4x4(v, o);  // o[j] byte i = v[i] byte j: n = 4 nq + j, k = 4 kq + i
    const int k = k0 + 4 * kq;
    if (k < Kp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * nq + j;
        if (n < N) *(uint32_t*)(bt + (size_t)n * Kp + k) = o[j];
      }
    }
  }
}

// ---------------------------------------------------------- product kernel

constexpr int kBM = 128;       // a tile's rows: two consumer warpgroups of 64
constexpr int kBK = 128;       // k a stage: 128 bytes of int8, the swizzle's width
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK;            // 16 KiB
constexpr int kOutBox = 32;                   // int32 columns a store box (128 bytes)
constexpr int kOutCols = 128;                 // columns staged at once (256: two rounds)
constexpr int kOutBytes = 64 * kOutCols * 4;  // a consumer's staging: 32 KiB

// a tile of BN columns: 128 where N is at most 128, else 256 (three 48
// KiB stages beside the staging)
template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 256, "wgmma m64n128k32 or m64n256k32");
  static constexpr int kStages = BN == 128 ? 4 : 3;
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kOutBytes + 2 * kStages * 8 +
                               1024;  // + barriers, + alignment slack
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
int8_mma_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                const __grid_constant__ CUtensorMap mc, int32_t* __restrict__ c, int M, int N,
                int K, int direct) {
  constexpr int kStages = Tile<BN>::kStages, kStageBytes = Tile<BN>::kStageBytes;
  extern __shared__ uint8_t raw[];
  uint8_t* sm = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);  // the swizzle's period
  uint8_t* stage0 = sm;
  int32_t* staged = (int32_t*)(sm + kStages * kStageBytes);
  uint64_t* full = (uint64_t*)(sm + kStages * kStageBytes + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  const int mt = (M + kBM - 1) / kBM, tiles = mt * ((N + BN - 1) / BN);
  const int KB = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // the producer
    if (t == 0) {
      hopper::prefetch_tmap(&ma);
      hopper::prefetch_tmap(&mb);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the staging pass is done
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * BN;
        for (int kb = 0; kb < KB; ++kb) {
          hopper::mbar_wait(&empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&full[s], kStageBytes);
          uint8_t* st = stage0 + s * kStageBytes;
          hopper::tma_load_3d(st, &ma, kb * kBK, m0, 0, &full[s]);
          hopper::tma_load_3d(st + kABytes, &mb, kb * kBK, n0, 0, &full[s]);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer: rows 64 cw .. 64 cw + 63 of each tile
  const int cw = wg - 1;
  const int w = t / 32, g = (t % 32) / 4, q = t % 4;
  int32_t acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;  // each tile's first wgmma overwrites them
  const uint32_t a0 = hopper::smem_u32(stage0) + cw * 64 * 128;
  const uint32_t b0 = hopper::smem_u32(stage0) + kABytes;
  int32_t* my = staged + cw * (kOutBytes / 4);
  int s = 0;
  uint32_t ph = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % mt) * kBM, n0 = (tile / mt) * BN;
    int prev = -1;
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb) {
      hopper::mbar_wait(&full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        const uint64_t da = hopper::sw128_desc(a0 + s * kStageBytes + kk * 32, 16, 1024);
        const uint64_t db = hopper::sw128_desc(b0 + s * kStageBytes + kk * 32, 16, 1024);
        if constexpr (BN == 128)
          hopper::wgmma_m64n128k32_s8(acc, da, db, kb > 0 || kk > 0);
        else
          hopper::wgmma_m64n256k32_s8(acc, da, db, kb > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the stage before this one is read
      if (prev >= 0 && t == 0) hopper::mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) hopper::fence_operand(acc[e]);
    if (t == 0) hopper::mbar_arrive(&empty[prev]);

    const int r0 = m0 + cw * 64;
    if (direct) {  // N % 4: each thread's sums straight to c
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 16 * w + g + 8 * h, col = n0 + 8 * j + 2 * q;
          if (row < M && col < N) c[(size_t)row * N + col] = acc[4 * j + 2 * h];
          if (row < M && col + 1 < N) c[(size_t)row * N + col + 1] = acc[4 * j + 2 * h + 1];
        }
      }
      continue;
    }
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += kOutCols) {  // one round unless BN is 256
      if (t == 0) hopper::bulk_wait_read<0>();  // the last stores have read `my`
      hopper::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = c0 / 8; j < (c0 + kOutCols) / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * w + g + 8 * h;
          const int u = 2 * (j % 4) + q / 2;  // the 16-byte unit in the box's 128-byte row
          int32_t* dst = my + (j % (kOutCols / 8) / 4) * (64 * kOutBox) + row * kOutBox +
                         ((u ^ (row & 7)) * 4) + (q & 1) * 2;
          *(int2*)dst = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + cw, 128);
      if (t == 0 && r0 < M) {
        for (int p = 0; p < kOutCols / kOutBox; ++p)
          if (n0 + c0 + p * kOutBox < N)
            hopper::tma_store_3d(&mc, my + p * (64 * kOutBox), n0 + c0 + p * kOutBox, r0, 0);
        hopper::bulk_commit();
      }
    }
  }
  if (t == 0) hopper::bulk_wait<0>();
}

template <int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mc, int32_t* c,
           int M, int N, int K, int direct, cudaStream_t stream) {
  // past the 48 KiB default: the opt-in (a per-device attribute, set each call)
  const cudaError_t optin = cudaFuncSetAttribute(
      int8_mma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (optin != cudaSuccess) return (int)optin;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);  // persistent: one block an SM at most
  // launched while the staging pass runs (programmatic dependent launch):
  // its set-up overlaps the pass, its loads wait for it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<BN>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_mma_kernel<BN>, ma, mb, mc, c, M, N, K,
                                             direct);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// the scratch bytes a call needs: b^T [N, Kp], and a's copy [M, Kp] where
// TMA cannot read a in place
extern "C" long long h2r_int8_mma_scratch(const void* a, int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0) return -1;
  const long long Kp = padded_k(K);
  return (long long)N * Kp + (a_in_place(a, K) ? 0 : (long long)M * Kp);
}

// a [M, K], b [K, N] int8 and c [M, N] int32, row-major; scratch holds
// h2r_int8_mma_scratch(a, M, N, K) bytes, 16-byte aligned.  Two launches:
// the staging pass, then the product kernel.
extern "C" int h2r_int8_mma(const void* a, const void* b, void* c, void* scratch, int M, int N,
                            int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ((uintptr_t)scratch | (uintptr_t)c) % 16)
    return (int)cudaErrorInvalidValue;
  const int Kp = padded_k(K);
  const bool in_place = a_in_place(a, K);
  int8_t* bt = (int8_t*)scratch;
  int8_t* ap = in_place ? nullptr : bt + (size_t)N * Kp;
  const long long tb = (long long)((N + kST - 1) / kST) * ((K + kST - 1) / kST);
  const long long ta = in_place ? 0 : ((long long)M * (Kp / 16) + 255) / 256;
  if (tb + ta > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int8_stage_kernel<<<(unsigned)(tb + ta), 256, 0, st>>>((const int8_t*)a, (const int8_t*)b, bt,
                                                         ap, M, N, K, (int)tb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int direct = N % 4 != 0;  // c's rows not 16-byte strided: no TMA stores
  CUtensorMap ma, mb, mc;
  if (!hopper::encode_3d(&ma, in_place ? a : ap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         in_place ? K : Kp, M, 1, kBK, kBM) ||
      !hopper::encode_3d(&mb, bt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, N, 1, kBK,
                         N > 128 ? 256 : 128) ||
      !hopper::encode_3d(&mc, c, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, direct ? 4 : N, M, 1,
                         kOutBox, 64))
    return (int)cudaErrorInvalidValue;
  const bool wide = N > 128;  // 128 x 256 tiles: 171 ops a byte from the L2, not 128
  return wide ? launch<256>(ma, mb, mc, (int32_t*)c, M, N, K, direct, st)
              : launch<128>(ma, mb, mc, (int32_t*)c, M, N, K, direct, st);
}
