// Shared definitions of the bitplane kernels (bitplane_pack.cu,
// bitplane_pack_raw.cu, bitplane_tpack.cu, bitplane_scan.cu,
// bitplane_post.cu, bitplane_decode.cu, bitplane_fb.cu).
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
//   H2R_EN_PACK (the pack kernels write the enable plane: 0 or 1);
//   H2R_SCAN_UNROLL (the scans' position-loop unroll);
//   H2R_SCAN_FUSED_PACK when the scan reads raw quad rows (no pack);
//   H2R_SCAN_DEF in the one-def header of scan_def;
//   witness bytes/kdecode: H2R_NGROUPS (byte groups of the post
//   emission), H2R_POST_TILED for tiled input (the post reads the quad
//   words), and for kdecode H2R_NFIELDS and H2R_FLAGS_FIELD (the decode's
//   fields); witness direct: H2R_POST_DIRECT, H2R_DFIELDS (fields) and
//   H2R_DPLANES (their planes in all);
//   planes mode (full, and witness planes): H2R_POST_PLANES, H2R_P_TOTAL
//   (planes of the post output) and the first plane of its fields
//   H2R_OFF_{IDSUM, MASKED_IDSUM, FWD, BWD, MASK} (full: the per-def
//   planes come first, in the order of dt) or H2R_OFF_{MASKED_IDSUM, FWD,
//   BWD, MASK, START_ANY, ENDF_ANY} (witness);
//   h2r_class(bb[8], cls[KP])           byte-bit planes -> class planes
//                                       (with the class stage off, KP = 8
//                                       and cls = bb)
//   h2r_step_init(st[NLIVE])            one-hot first states
//   h2r_step(cls[KP], st[NLIVE], lg[SB_SUM])   one byte, every def
//   h2r_first_log(lg[SB_SUM])           log planes of the first states
//   h2r_tag(prev, next, en, ids[NSUM], start_any, endf_any, dt[NDT])
//   h2r_fb(acc[SB_SUM], empty, fb[NDEFS*8])
//   witness bytes/kdecode: h2r_emit(flags[6], midsum[NSUM],
//                          lg[SB_SUM], en, mcp[8], words[8*NGROUPS])
//                          (mcp: the masked byte-bit planes, read in tiled
//                          mode only)
//   witness direct: h2r_direct_planes(flags[6], midsum[NSUM], lg[SB_SUM],
//                          en, pl[DPLANES])  every field's planes in order;
//                   h2r_direct_field(f, off, nb)  field f's first plane
//                          in pl and its plane count (<= 8)
//   kdecode: h2r_decode_fields(gw[NGROUPS], fw[NFIELDS])  byte-group words
//                          of one position -> each field, every byte lane
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define H2R_LANE 128

// #pragma unroll with a macro's value as its count
#define H2R_PRAGMA(x) _Pragma(#x)
#define H2R_PRAGMA_UNROLL(n) H2R_PRAGMA(unroll n)

// The 4 x 4 byte transpose of the direct and kdecode emissions' row
// writes: o[s] byte j = v[j] byte s (v[j]: 4 strings' bytes at position
// j; o[s]: string s's bytes at 4 positions).
static __device__ __forceinline__ void h2r_bytes4x4(const uint32_t* v, uint32_t* o) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362), t3 = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

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

// The 8 byte-bit planes of one position from its 8 quad words q[m] (bytes
// s = 0..3 of strings 4 * (w + NW * m) + s): bit 8s + m of plane j is bit
// j of that string's byte.  Port of the pack kernels' quad-mask OR
// (halo2_regex_tpu/ops/bitplane.py:1051-1058).  That is the 8 x 8 bit
// transpose within each byte lane (plane j byte s bit m = word m byte s
// bit j), which h2r_transpose8 is, in about 72 operations for the 256 of
// the 8 x 8 shift-and-OR.
static __device__ __forceinline__ void h2r_byte_planes(const uint32_t* q, uint32_t* bb) {
#pragma unroll
  for (int m = 0; m < 8; ++m) bb[m] = q[m];
  h2r_transpose8(bb);
}

// 32 x 32 bit transpose across a warp (the enable planes of K1 and of the
// quad-word pack): lane r holds row r (bit c = entry (r, c)); afterwards
// lane r holds column r (bit c = the input's entry (c, r)).  Each round j
// swaps bit j of the row and column index.
static __device__ __forceinline__ uint32_t h2r_warp_transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int j = 16; j >= 1; j >>= 1) {
    const uint32_t hi = j == 16 ? 0xFFFF0000u
                        : j == 8 ? 0xFF00FF00u
                        : j == 4 ? 0xF0F0F0F0u
                        : j == 2 ? 0xCCCCCCCCu : 0xAAAAAAAAu;  // columns with bit j
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = (lane & j) ? (x & hi) | ((y >> j) & ~hi) : (x & ~hi) | ((y << j) & hi);
  }
  return x;
}
