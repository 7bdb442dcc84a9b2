// The pack from quad words, shared by pack_raw (B5, bitplane_pack_raw.cu)
// and tpack (B6, bitplane_tpack.cu): the two read the same quad words in
// two layouts and compute the same class planes and enable plane.  Include
// after "h2r_circuits.cuh" (it calls h2r_class).  The modes of the JAX
// pack kernels come from the header: binary or one-hot class planes, or
// the 8 byte-bit planes with the class stage off (KP = 8); no enable
// plane with en_pack off (H2R_EN_PACK 0; raw-quads pack only, since the
// tiled contract always computes it).
//
// Quad word (nws, m, l) of lane `lane` holds bytes s = 0..3 of strings
// 4 * (w + NW * m) + s at position l, w = nws * 128 + lane; it sits at
//     quads[nws * s_nws + m * s_m + l * s_l + lane]
// (raw quad rows [L_pad, 8, NWS, 128]: s_nws = 128, s_m = NW, s_l = 8 NW;
// pretiled words [NWS, 8, L_pad, 128]: s_nws = 8 L_pad 128, s_m = L_pad
// 128, s_l = 128).  Either way a warp's 32 loads at one (m, l) are one
// contiguous 128-byte segment, so no staging is needed.
//
// Design: one thread owns one word w (32 strings) for TL consecutive
// positions; a block is one row of 128 words (coalesced loads and stores
// over words) and grid.y runs over the L_pad / TL position tiles, so
// B=32768 x L_pad=1024 gives 8 x 64 = 512 blocks.  Each thread reads its
// word's 32 string lengths once (8 x 16 B loads) and reuses them for its
// TL positions.  Positions past L are zero bytes in the quad words and
// have enable 0 (every length is <= L).
//
// Outputs: out [L_pad, KP, NWS, 128] int32; en [NWS, L_pad, 128] int32;
// len_wb [NWS, 128, 32] int32.
#pragma once

namespace {

constexpr int kPackTL = 16;  // positions per thread

__global__ void __launch_bounds__(H2R_LANE)
pack_words_kernel(const int32_t* __restrict__ quads, long long s_nws, long long s_m,
                  long long s_l, const int32_t* __restrict__ len_wb,
                  int32_t* __restrict__ out, int32_t* __restrict__ en, int NW, int L) {
  const int nws = blockIdx.x, lane = threadIdx.x;
  const int w = nws * H2R_LANE + lane;
  const int l0 = blockIdx.y * kPackTL;
#if H2R_EN_PACK
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
#endif
  const int32_t* qw = quads + nws * s_nws + lane;
#pragma unroll 2
  for (int p = 0; p < kPackTL; ++p) {
    const int l = l0 + p;
    if (l >= L) break;
    uint32_t q[8], bb[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) q[m] = (uint32_t)qw[m * s_m + l * s_l];
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
    en[((size_t)nws * L + l) * H2R_LANE + lane] = (int32_t)e;
#endif
  }
}

inline int h2r_pack_words(const void* quads, long long s_nws, long long s_m, long long s_l,
                          const void* len_wb, void* out, void* en, int NW, int L,
                          void* stream) {
  const dim3 grid(NW / H2R_LANE, (L + kPackTL - 1) / kPackTL);
  pack_words_kernel<<<grid, H2R_LANE, 0, (cudaStream_t)stream>>>(
      (const int32_t*)quads, s_nws, s_m, s_l, (const int32_t*)len_wb, (int32_t*)out,
      (int32_t*)en, NW, L);
  return (int)cudaGetLastError();
}

}  // namespace
