// tile_move -- the tile copy and transpose probes of tools/ as one H100
// kernel, two forms as template instances: probe_tpu47.py's kern_t
// (pallas_call at :44, the transpose of (LC, LANE) tiles) and kern_c (:60,
// their copy), probe_tpu48.py's kern_id (:84, the copy of whole planes)
// and probe_tpu64.py's kern_copy and kern_swap (mkk, pallas_call at :161).
//
// The function: x [N, R, C] int32, R and C multiples of 4 ->
//   TRANSPOSE: y [N, C, R], y[n, c, r] = x[n, r, c];
//   COPY:      y [N, R, C] = x.
// The TPU blocks (LC = 256 positions x 128 lanes, or a whole plane) are
// the probes' VMEM tiling; the function is the same at any tiling.
//
// What bounds it on the H100: device-memory bytes, each word read once
// and written once (at [8, 8, 1024, 128], 2 x 33.5 MB).
//
// Design: a block of 256 threads moves a tile of 64 x 64 words through
// 16 KiB of shared memory, 16-byte global loads and stores on both sides
// (a warp covers two 256-byte row pieces on the way in, four 128-byte
// lines on the way out of the transpose).  The tile is stored as 16-byte
// chunks, chunk ch of row r at slot ch ^ (r / 4) of the row (an XOR
// swizzle, in place of a padded pitch: a pitch of 65 words would break
// the 16-byte alignment of the chunks).  Each 8-thread phase of a
// chunk store writes 8 different slots of one row, and each word read of
// the transpose (column c of rows 4 r4 .. 4 r4 + 3, 8 values of r4 and 4
// of c a warp) lands in 32 different banks: no bank conflicts on either
// side.  COPY runs the same staging and reads the chunks back row-wise,
// so the two forms differ in the transpose alone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;                     // tile rows and columns, words
constexpr int CH = T / 4;                 // 16-byte chunks a tile row
constexpr int THREADS = 256;
constexpr int PASSES = T * CH / THREADS;  // chunks a thread moves

// the slot of chunk ch of tile row r
__device__ __forceinline__ int slot(int r, int ch) { return r * CH + (ch ^ ((r >> 2) & (CH - 1))); }

template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
tile_move_kernel(const int4* __restrict__ x, int4* __restrict__ y, int R, int C) {
  __shared__ int4 tile[T * CH];
  const int r0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int C4 = C / 4, R4 = R / 4;
  const size_t n_off = (size_t)blockIdx.z * R * C4;  // chunks a matrix
  const int4* xn = x + n_off;
  int4* yn = y + n_off;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int i = p * THREADS + threadIdx.x, r = i / CH, ch = i % CH;
    const int gr = r0 + r, gc = c0 / 4 + ch;
    if (gr < R && gc < C4) tile[slot(r, ch)] = __ldg(xn + (size_t)gr * C4 + gc);
  }
  __syncthreads();
  if constexpr (!TRANSPOSE) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int i = p * THREADS + threadIdx.x, r = i / CH, ch = i % CH;
      const int gr = r0 + r, gc = c0 / 4 + ch;
      if (gr < R && gc < C4) yn[(size_t)gr * C4 + gc] = tile[slot(r, ch)];
    }
  } else {
    // item (c, r4): output row c, chunk r4 (rows 4 r4 .. 4 r4 + 3 of the
    // tile); a warp holds 4 values of c and 8 consecutive r4
    const int* t32 = (const int*)tile;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int s = (p * THREADS + threadIdx.x) >> 5;
      const int c = 4 * (s >> 1) + (lane >> 3), r4 = 8 * (s & 1) + (lane & 7);
      const int gc = c0 + c, gr4 = r0 / 4 + r4;
      if (gc < C && gr4 < R4) {
        int4 v;
        v.x = t32[4 * slot(4 * r4 + 0, c >> 2) + (c & 3)];
        v.y = t32[4 * slot(4 * r4 + 1, c >> 2) + (c & 3)];
        v.z = t32[4 * slot(4 * r4 + 2, c >> 2) + (c & 3)];
        v.w = t32[4 * slot(4 * r4 + 3, c >> 2) + (c & 3)];
        yn[(size_t)gc * R4 + gr4] = v;
      }
    }
  }
}

}  // namespace

// x [N, R, C] int32 -> y: form 0 copy ([N, R, C]), 1 transpose ([N, C, R]);
// R and C multiples of 4, N at most 65535, both pointers 16-byte aligned
extern "C" int h2r_tile_move(const void* x, void* y, int N, int R, int C, int form,
                             void* stream) {
  if (N <= 0 || N > 65535 || R <= 0 || C <= 0 || R % 4 || C % 4 || form < 0 || form > 1 ||
      (((uintptr_t)x | (uintptr_t)y) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + T - 1) / T, (R + T - 1) / T, N);
  cudaStream_t st = (cudaStream_t)stream;
  if (form == 1)
    tile_move_kernel<true><<<grid, THREADS, 0, st>>>((const int4*)x, (int4*)y, R, C);
  else
    tile_move_kernel<false><<<grid, THREADS, 0, st>>>((const int4*)x, (int4*)y, R, C);
  return (int)cudaGetLastError();
}
