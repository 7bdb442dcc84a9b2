// pack_raw -- raw quad rows -> class planes and enable plane.
//
// Replaces the TPU kernel BitplaneMatcher._make_pack
// (halo2_regex_tpu/ops/bitplane.py:1040, pallas_call at :1124) in each of
// its modes (binary, one-hot or no class stage; en_pack on or off; see
// bitplane_pack_words.cuh).  The matcher takes it where K1 (qpack) cannot
// run: L_pad != L (L > 128 and not a multiple of 128), or qpack=False.
//
// What bounds it on the H100: device-memory bytes.  It reads the raw quad
// rows (1 B per input byte, as a torch transpose of the [B, L] bytes left
// them: 32 strings x 1 position per 32 B) and writes (KP + 1) * 4 / 32 B
// per input byte.  Unlike K1, whose strings' bytes sit 4L apart in the
// [B, L] input, row (l, m) holds 128 consecutive words of one position: a
// contiguous 512-byte piece, which the kernel copies to shared memory with
// cp.async.  The kernel is bitplane_pack_words.cuh's, shared with tpack
// (B6).
//
// Layouts: quads [L_pad, 8, NWS, 128] int32 (row (l, m), word w holds the
// bytes s = 0..3 of strings 4 * (w + NW * m) + s at position l); len_wb
// [NWS, 128, 32] int32; out [L_pad, KP, NWS, 128] int32; en [NWS, L_pad,
// 128] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"
#include "bitplane_pack_words.cuh"

extern "C" int h2r_pack_raw(const void* quads, const void* len_wb, void* out, void* en,
                            int NW, int L, void* stream) {
  return h2r_pack_words(quads, H2R_LANE, NW, 8LL * NW, len_wb, out, en, NW, L, stream);
}
