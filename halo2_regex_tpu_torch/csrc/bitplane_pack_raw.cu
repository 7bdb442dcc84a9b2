// pack_raw -- raw quad rows -> class planes and enable plane.
//
// Replaces the TPU kernel BitplaneMatcher._make_pack with the class stage
// and en_pack on (halo2_regex_tpu/ops/bitplane.py:1040, pallas_call at
// :1124).  The matcher takes it where K1 (qpack) cannot run: L_pad != L
// (L > 128 and not a multiple of 128), or qpack=False.
//
// What bounds it on the H100: device-memory bytes, in principle.  It
// reads the raw quad rows (1 B per input byte, as a torch transpose of the
// [B, L] bytes left them: 32 strings x 1 position per 32 B) and writes
// (KP + 1) * 4 / 32 B per input byte.  Unlike K1, whose strings' bytes sit
// 4L apart in the [B, L] input and must be staged through shared memory,
// here row (l, m) holds 128 consecutive words of one position, so a warp's
// 32 loads are one contiguous 128 B segment and need no staging.  The
// per-word bit work (8 x 8 quad-bit extractions, the class circuit, 32
// length compares for the enable bits) is the other cost.
//
// Design: one thread owns one word w (32 strings) for TL consecutive
// positions; a block is one row of 128 words (coalesced loads and stores
// over words) and grid.y runs over the L_pad / TL position tiles, so
// B=32768 x L_pad=1024 gives 8 x 64 = 512 blocks.  Each thread reads its
// word's 32 string lengths once (8 x 16 B loads) and reuses them for its
// TL positions.  Positions past L are zero bytes in the quad rows
// (raw_quads pads them) and have enable 0 (every length is <= L).
//
// Layouts: quads [L_pad, 8, NWS, 128] int32 (row (l, m), word w holds the
// bytes s = 0..3 of strings 4 * (w + NW * m) + s at position l); len_wb
// [NWS, 128, 32] int32; out [L_pad, KP, NWS, 128] int32; en [NWS, L_pad,
// 128] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int TL = 16;  // positions per thread

__global__ void __launch_bounds__(H2R_LANE)
pack_raw_kernel(const int32_t* __restrict__ quads, const int32_t* __restrict__ len_wb,
                int32_t* __restrict__ out, int32_t* __restrict__ en, int NW, int L) {
  const int nws = blockIdx.x, lane = threadIdx.x;
  const int w = nws * H2R_LANE + lane;
  const int l0 = blockIdx.y * TL;
  int32_t lens[32];
  const int4* lp = reinterpret_cast<const int4*>(len_wb + (size_t)w * 32);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int4 v = lp[i];
    lens[4 * i] = v.x;
    lens[4 * i + 1] = v.y;
    lens[4 * i + 2] = v.z;
    lens[4 * i + 3] = v.w;
  }
#pragma unroll 2
  for (int p = 0; p < TL; ++p) {
    const int l = l0 + p;
    if (l >= L) break;
    uint32_t bb[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const uint32_t q = (uint32_t)quads[((size_t)l * 8 + m) * NW + w];
#pragma unroll
      for (int j = 0; j < 8; ++j) bb[j] |= ((q >> j) & 0x01010101u) << m;
    }
    uint32_t cls[H2R_KP];
    h2r_class(bb, cls);
#pragma unroll
    for (int k = 0; k < H2R_KP; ++k)
      out[((size_t)l * H2R_KP + k) * NW + w] = (int32_t)cls[k];
    uint32_t e = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) e |= (uint32_t)(l < lens[b]) << b;
    en[((size_t)nws * L + l) * H2R_LANE + lane] = (int32_t)e;
  }
}

}  // namespace

extern "C" int h2r_pack_raw(const void* quads, const void* len_wb, void* out, void* en,
                            int NW, int L, void* stream) {
  dim3 grid(NW / H2R_LANE, (L + TL - 1) / TL);
  pack_raw_kernel<<<grid, H2R_LANE, 0, (cudaStream_t)stream>>>(
      (const int32_t*)quads, (const int32_t*)len_wb, (int32_t*)out, (int32_t*)en, NW, L);
  return (int)cudaGetLastError();
}
