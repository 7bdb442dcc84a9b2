// K1: qpack -- [B, L] bytes -> class planes and enable plane.
//
// Replaces the TPU kernel BitplaneMatcher._make_qpack
// (halo2_regex_tpu/ops/bitplane.py:1138, pallas_call at :1229), in each of
// its modes: the class planes are binary or one-hot (the generated
// h2r_class), or, with the class stage off, the 8 byte-bit planes
// themselves (KP = 8); with en_pack off (H2R_EN_PACK 0) it writes no
// enable plane (en is a null pointer) and torch ops build it.
//
// What bounds it on the H100: by bytes it would be device memory -- it
// reads 1 B per input byte and writes (KP + 1) * 4 / 32 B per input byte
// (KP class planes plus the enable plane, 32 strings per word), about
// 17 us at B=32768 x L=1024 -- but in practice the instructions that move
// the input into shared memory and the per-word bit work (a few hundred
// integer ops per 32 input bytes) bound it; see the design note.
//
// Design: one block owns a tile of TW = 32 words (one warp's lanes) x
// TL = 32 positions, i.e. the 1024 strings g(w, beta) of those words.  For
// a fixed beta % 8 = m, the words' strings are 128 consecutive rows
// 4 * (w0 + NW * m) + [0, 128), so the tile is staged through shared
// memory with coalesced reads (4 strings x 32 bytes per warp load when
// L % 4 == 0, else one string's 32 bytes), instead of the stride-4L reads
// a direct per-word gather makes.  Shared memory holds the tile
// position-major, so the 4 bytes s = 0..3 of strings 4 * wl + s at one
// position -- the quad word the bit planes are built from -- are one
// aligned 32-bit shared load; rows are NSTR + 4 bytes apart, which keeps
// both the staging stores and the quad loads free of bank conflicts.
// Each thread then builds, per word and position, the 8 byte-bit planes,
// runs every def's class circuit (generated h2r_class) and writes planes
// coalesced over words.  Measured on the H100 (from: model, B=32768 x
// L=1024), the earlier byte-wise staging took 0.16 ms whether the input
// sat in L2 or not, and 0.07 ms without its global byte loads: the load
// instructions, not device-memory bytes, were the limit.
//
// Layouts: chars [B, L] uint8; len_wb [NWS, 128, 32] int32 (length of
// string g(w, beta) at [w, beta]; unread with en_pack off); out [L, KP,
// NWS, 128] int32; en [NWS, L, 128] int32 (en_pack only).

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int TW = 32;            // words per tile (one warp's lanes)
constexpr int TL = 32;            // positions per tile
constexpr int NSTR = 32 * TW;     // strings of one tile
constexpr int ROWB = NSTR + 4;    // shared bytes per position row
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qpack_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ len_wb,
             int32_t* __restrict__ out, int32_t* __restrict__ en, int NW, int L, int vec) {
  // tile[p * ROWB + j]: byte at position l0 + p of tile string j, where
  // string j = m * 128 + 4 * wl + s is 4 * (w0 + NW * m) + 4 * wl + s
  __shared__ __align__(16) uint8_t tile[TL * ROWB];
  const int w0 = blockIdx.x * TW;
  const int l0 = blockIdx.y * TL;

  if (vec) {  // L % 4 == 0 and chars 4-byte aligned: 4 positions per load
    for (int i = threadIdx.x; i < NSTR * TL / 4; i += THREADS) {
      const int j = i / (TL / 4), c = i % (TL / 4);
      const size_t g = 4 * ((size_t)w0 + (size_t)NW * (j >> 7)) + (j & 127);
      const int l = l0 + 4 * c;
      const uint32_t v = l < L ? *(const uint32_t*)(chars + g * L + l) : 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) tile[(4 * c + b) * ROWB + j] = (uint8_t)(v >> (8 * b));
    }
  } else {
    for (int i = threadIdx.x; i < NSTR * TL; i += THREADS) {
      const int j = i / TL, p = i % TL;
      const size_t g = 4 * ((size_t)w0 + (size_t)NW * (j >> 7)) + (j & 127);
      const int l = l0 + p;
      tile[p * ROWB + j] = l < L ? chars[g * L + l] : 0;
    }
  }
  __syncthreads();

  const int wl = threadIdx.x % TW;
  const int w = w0 + wl;
#if H2R_EN_PACK
  int32_t lens[32];
#pragma unroll
  for (int b = 0; b < 32; ++b) lens[b] = len_wb[(size_t)w * 32 + b];
#endif

  for (int p = threadIdx.x / TW; p < TL; p += THREADS / TW) {
    const int l = l0 + p;
    if (l >= L) break;
    uint32_t q[8], bb[8];
#pragma unroll
    for (int m = 0; m < 8; ++m)  // bytes s = 0..3 of strings 4 * wl + s of chunk m
      q[m] = *(const uint32_t*)(tile + p * ROWB + m * 128 + 4 * wl);
    h2r_byte_planes(q, bb);
    uint32_t cls[H2R_KP];
    h2r_class(bb, cls);
#pragma unroll
    for (int k = 0; k < H2R_KP; ++k)
      out[((size_t)l * H2R_KP + k) * NW + w] = (int32_t)cls[k];
#if H2R_EN_PACK
    uint32_t e = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) e |= (uint32_t)(l < lens[b]) << b;
    const int nws = w / H2R_LANE, lane = w % H2R_LANE;
    en[((size_t)nws * L + l) * H2R_LANE + lane] = (int32_t)e;
#endif
  }
}

}  // namespace

extern "C" int h2r_qpack(const void* chars, const void* len_wb, void* out, void* en,
                         int B, int L, int vec, void* stream) {
  const int NW = B / 32;
  dim3 grid(NW / TW, (L + TL - 1) / TL);
  qpack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int32_t*)len_wb, (int32_t*)out, (int32_t*)en, NW, L, vec);
  return (int)cudaGetLastError();
}
