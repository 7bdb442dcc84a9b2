// mma_accum -- probe_tpu21.py's D (mm_kern :97, pallas_call at :112) and
// probe_tpu20.py's D (mm_kern :211, pallas_call at :226, whose block shapes
// make it raise; probe_tpu21 corrected them) on wgmma and TMA:
// out[i, l] = sum over l' <= l of a[i, l'] @ b[i, l'], bf16 a [NI, NL, M, K]
// and b [NI, NL, K, N], f32 out [NI, NL, M, N].  The TPU carried the sum
// across its second grid axis in VMEM scratch; here a block owns one
// 128 x BN tile of one i (BN 128 where N is at most 128, else 256), walks
// l itself and keeps the f32 sum in registers across every l, storing the
// running sum at each l.
//
// Design (warp-specialised, one block an SM by its shared memory):
// - warpgroup 0 is the producer: one thread keeps a ring of stages in
//   flight by TMA (4 of 32 KiB, or 3 of 48 KiB at BN 256), each a
//   [128 x 64] box of a (K-major) and up to BN / 64 [64 x 64] boxes of b in
//   b's own layout (N contiguous: wgmma reads it as an MN-major operand, so
//   nothing is transposed), all with the 128-byte swizzle; a full mbarrier
//   a stage counts the bytes in, an empty one (two arrivals) hands the
//   stage back;
// - warpgroups 1 and 2 are the consumers, 64 rows each: four
//   wgmma.m64nBNk16 a stage, one commit group kept in flight (the stage
//   before is released when its group is done);
// - at the end of each l the running sum goes through shared memory (the
//   128-byte swizzle: conflict-free float2 writes) and out by TMA stores of
//   [64 x 32] boxes in one bulk group a round of 128 columns, which drain
//   while l + 1's loads, in flight already, are multiplied.
// The maps are 3-D ([NI NL, rows, cols]), so TMA zero-fills a box past a
// matrix's own rows or columns and clips the stores there: M and N need
// only be multiples of 64 (a tile may hang over the edge) and K of 32 (the
// last k box zero-filled).  A b box wholly past N is not loaded: the stale
// stage it leaves only reaches output columns that are never stored.
// What bounds it: at [4, 8, 1024, 1024] bytes (64 + 64 MB in, 128 MB out)
// and the bf16 tensor-core rate about equally; 128 x 128 tiles ask the L2
// for 64 flops a byte, which at the tensor cores' rate is more than it
// serves, so wide N takes 128 x 256 (85 a byte).  At the probe's
// [4, 2, 128, 128] a launch (4 blocks).  Products of bf16 values are exact
// in f32; the sums are exact for integer values under 2^24.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kBM = 128;        // a tile's rows: two consumer warpgroups of 64
constexpr int kBK = 64;         // k a stage: 128 bytes of bf16, the swizzle's width
constexpr int kThreads = 384;   // producer warpgroup + two consumers
constexpr int kABytes = kBM * kBK * 2;              // 16 KiB
constexpr int kBPiece = kBK * 64 * 2;               // 8 KiB: [64 k][64 n]
constexpr int kOutBox = 32;                         // f32 columns a store box (128 bytes)
constexpr int kOutCols = 128;                       // columns staged at once (256: two rounds)
constexpr int kOutBytes = 64 * kOutCols * 4;        // a consumer's staging: 32 KiB
// b's descriptor: 64-wide N pieces kBPiece apart, 8-k groups 1024 bytes apart
constexpr uint32_t kLboB = kBPiece, kSboB = 1024;

// a tile of BN columns (m64n128 or m64n256 a k16 step): 128 where N is at
// most 128, else 256, whose 48 KiB stages leave room for three beside the
// staging; each stage one A box and BN / 64 B pieces
template <int BN>
struct Tile {
  static_assert(BN == 128 || BN == 256, "wgmma m64n128 or m64n256");
  static constexpr int kStages = BN == 128 ? 4 : 3;
  static constexpr int kStageBytes = kABytes + kBPiece * (BN / 64);
  static constexpr int kSmem = kStages * kStageBytes + 2 * kOutBytes + 2 * kStages * 8 +
                               1024;  // + barriers, + alignment slack
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
mma_accum_tma_kernel(const __grid_constant__ CUtensorMap ma,
                     const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ CUtensorMap mo, int NL, int M, int N, int K) {
  constexpr int kBN = BN, kStages = Tile<BN>::kStages, kStageBytes = Tile<BN>::kStageBytes;
  extern __shared__ uint8_t raw[];
  // 1024-byte aligned (the swizzle's period), kept a shared pointer so
  // the staging writes compile to STS
  uint8_t* sm = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  uint8_t* stage0 = sm;
  float* staged = (float*)(sm + kStages * kStageBytes);
  uint64_t* full = (uint64_t*)(sm + kStages * kStageBytes + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, i = blockIdx.z;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int KB = (K + kBK - 1) / kBK;
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
      const int pieces = min(kBN / 64, (N - n0) / 64);  // b boxes inside N
      const uint32_t bytes = kABytes + pieces * kBPiece;
      int s = 0;
      uint32_t ph = 0;
      for (int l = 0; l < NL; ++l) {
        const int z = i * NL + l;
        for (int kb = 0; kb < KB; ++kb) {
          hopper::mbar_wait(&empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&full[s], bytes);
          uint8_t* st = stage0 + s * kStageBytes;
          hopper::tma_load_3d(st, &ma, kb * kBK, m0, z, &full[s]);
          for (int p = 0; p < pieces; ++p)
            hopper::tma_load_3d(st + kABytes + p * kBPiece, &mb, n0 + 64 * p, kb * kBK, z,
                                &full[s]);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer: rows 64 cw .. 64 cw + 63 of the tile
  const int cw = wg - 1;
  const int w = t / 32, g = (t % 32) / 4, q = t % 4;
  float acc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.f;
  const uint32_t a0 = hopper::smem_u32(stage0) + cw * 64 * 128;
  const uint32_t b0 = hopper::smem_u32(stage0) + kABytes;
  float* my = staged + cw * (kOutBytes / 4);
  int s = 0, prev = -1;
  uint32_t ph = 0;
#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
#pragma unroll 1
    for (int kb = 0; kb < KB; ++kb) {
      hopper::mbar_wait(&full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = hopper::sw128_desc(a0 + s * kStageBytes + kk * 32, 16, 1024);
        const uint64_t db = hopper::sw128_desc(b0 + s * kStageBytes + kk * 16 * 128, kLboB, kSboB);
        if constexpr (kBN == 128)
          hopper::wgmma_m64n128k16_bf16<1>(acc, da, db);
        else
          hopper::wgmma_m64n256k16_bf16<1>(acc, da, db);
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
    if (t == 0) hopper::mbar_arrive(&empty[prev]);
    prev = -1;

    // l's running sum
    const int z = i * NL + l;
    const int r0 = m0 + cw * 64;
#pragma unroll
    for (int c0 = 0; c0 < kBN; c0 += kOutCols) {  // one round unless kBN is 256
      if (t == 0) hopper::bulk_wait_read<0>();  // the last stores have read `my`
      hopper::named_sync(1 + cw, 128);
#pragma unroll
      for (int j = c0 / 8; j < (c0 + kOutCols) / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * w + g + 8 * h;
          const int u = 2 * (j % 4) + q / 2;  // the 16-byte unit in the box's 128-byte row
          float* dst = my + (j % (kOutCols / 8) / 4) * (64 * kOutBox) + row * kOutBox +
                       ((u ^ (row & 7)) * 4) + (q & 1) * 2;
          *(float2*)dst = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + cw, 128);
      if (t == 0 && r0 < M) {
        for (int p = 0; p < kOutCols / kOutBox; ++p)
          if (n0 + c0 + p * kOutBox < N)
            hopper::tma_store_3d(&mo, my + p * (64 * kOutBox), n0 + c0 + p * kOutBox, r0, z);
        hopper::bulk_commit();
      }
    }
  }
  if (t == 0) hopper::bulk_wait<0>();
}

template <int BN>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mo, int NI, int NL,
           int M, int N, int K, cudaStream_t stream) {
  // past the 48 KiB default: the opt-in (a per-device attribute, set each call)
  const cudaError_t optin = cudaFuncSetAttribute(
      mma_accum_tma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (optin != cudaSuccess) return (int)optin;
  const dim3 grid((N + BN - 1) / BN, (M + kBM - 1) / kBM, NI);
  mma_accum_tma_kernel<BN><<<grid, kThreads, Tile<BN>::kSmem, stream>>>(ma, mb, mo, NL, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, c 16-byte aligned; M and N multiples of 64, K of 32 (the wrapper
// checks).  The tensor maps are encoded here for every call (the pointers
// change).
extern "C" int h2r_mma_accum(const void* a, const void* b, void* c, int NI, int NL, int M, int N,
                             int K, void* stream) {
  if (NI <= 0 || NI > 65535 || NL <= 0 || M <= 0 || N <= 0 || K <= 0 || M % 64 || N % 64 ||
      K % 32 || (M + kBM - 1) / kBM > 65535 ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16)
    return (int)cudaErrorInvalidValue;
  const uint64_t Z = (uint64_t)NI * NL;
  CUtensorMap ma, mb, mo;
  if (!hopper::encode_3d(&ma, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, Z, kBK, kBM) ||
      !hopper::encode_3d(&mb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, Z, 64, kBK) ||
      !hopper::encode_3d(&mo, c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, M, Z, kOutBox, 64))
    return (int)cudaErrorInvalidValue;
  const bool wide = N > 128;  // 128 x 256 tiles: 85 flops a byte from the L2, not 64
  return wide ? launch<256>(ma, mb, mo, NI, NL, M, N, K, (cudaStream_t)stream)
              : launch<128>(ma, mb, mo, NI, NL, M, N, K, (cudaStream_t)stream);
}
