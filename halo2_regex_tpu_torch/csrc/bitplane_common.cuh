// Shared definitions of the bitplane kernels (bitplane_pack.cu,
// bitplane_pack_raw.cu, bitplane_tpack.cu, bitplane_scan.cu,
// bitplane_post.cu, bitplane_fb.cu).
//
// Packed layout (the JAX package's, kept exactly): 32 strings share one
// 32-bit word.  Word w of a plane holds, at bit beta, string
//     g(w, beta) = 4 * (w + NW * (beta % 8)) + beta / 8,   NW = B / 32,
// and planes are rows of LANE = 128 words, NWS = NW / 128 rows.  Every
// kernel computes on uint32_t (the torch tensors are int32; the kernels
// reinterpret the bits), so shifts are logical and never undefined.
//
// Each kernel file includes this header and then "h2r_circuits.cuh", the
// per-model header that ops/kernels.py generates from the synthesized
// circuits, for one column set.  It defines:
//   H2R_NDEFS, H2R_KP (class planes), H2R_SB_SUM (log planes),
//   H2R_NLIVE (one-hot state planes), H2R_NSUM (id-sum planes),
//   H2R_NDT (per-def tag planes: NDEFS * (id bits + 2));
//   witness only: H2R_NGROUPS (byte groups of the post emission), and
//   H2R_POST_TILED for tiled input (the post reads the quad words);
//   full only: H2R_POST_PLANES, H2R_P_TOTAL (planes of the post output)
//   and the first plane of its fields H2R_OFF_{IDSUM, MASKED_IDSUM, FWD,
//   BWD, MASK} (the per-def planes come first, in the order of dt);
//   h2r_class(bb[8], cls[KP])           byte-bit planes -> class planes
//   h2r_step_init(st[NLIVE])            one-hot first states
//   h2r_step(cls[KP], st[NLIVE], lg[SB_SUM])   one byte, every def
//   h2r_first_log(lg[SB_SUM])           log planes of the first states
//   h2r_tag(prev, next, en, ids[NSUM], start_any, endf_any, dt[NDT])
//   h2r_fb(acc[SB_SUM], empty, fb[NDEFS*8])
//   witness only: h2r_emit(flags[6], midsum[NSUM], lg[SB_SUM], en,
//                          mcp[8], words[8*NGROUPS]) (mcp: the masked
//                          byte-bit planes, read in tiled mode only)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define H2R_LANE 128

// SWAR 8x8 bit-block transpose of eight planes: afterwards word b holds,
// in byte lane s bit j, the input bit P_j[8s + b], i.e. the value bytes of
// the four strings at beta % 8 == b.  Port of transpose8_planes
// (halo2_regex_tpu/ops/bitplane.py:204); on uint32_t the shifts are
// logical, and the masks make them agree with the arithmetic original.
static __device__ __forceinline__ void h2r_transpose8(uint32_t* x) {
#pragma unroll
  for (int d = 4; d >= 1; d >>= 1) {
    const uint32_t m = d == 4 ? 0x0F0F0F0Fu : (d == 2 ? 0x33333333u : 0x55555555u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & d) continue;
      const uint32_t a = x[i], b = x[i + d];
      const uint32_t t = ((a >> d) ^ b) & m;
      x[i + d] = b ^ t;
      x[i] = a ^ (t << d);
    }
  }
}
