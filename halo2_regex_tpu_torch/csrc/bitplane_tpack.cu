// tpack -- pretiled quad words -> class planes and enable plane.
//
// Replaces the TPU kernel BitplaneMatcher._make_tpack (B6,
// halo2_regex_tpu/ops/bitplane.py:1243, pallas_call at :1324), the pack of
// the tiled input contract (input_layout="tiled"): the host hands over the
// [NWS, 8, L_pad, 128] int32 quad words of tile_corpus, and the outputs
// are those of K1 qpack with en_pack on, in each class-stage mode.
//
// What bounds it on the H100: device-memory bytes.  It reads 1 B per input
// byte plus the length table and writes (KP + 1) * 4 / 32 B per input byte
// (52 MiB in all at B=32768 x L=1024 for the from: model).  The tiled
// words are the raw quad rows with the word group leading: the same
// 512-byte pieces, so the kernel is bitplane_pack_words.cuh's with the
// tiled strides.
//
// Layouts: tiled [NWS, 8, L_pad, 128] int32; len_wb [NWS, 128, 32] int32;
// out [L_pad, KP, NWS, 128] int32; en [NWS, L_pad, 128] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"
#include "bitplane_pack_words.cuh"

extern "C" int h2r_tpack(const void* tiled, const void* len_wb, void* out, void* en, int NW,
                         int L, void* stream) {
  const long long row = (long long)L * H2R_LANE;  // one (nws, m) slab
  return h2r_pack_words(tiled, 8 * row, row, H2R_LANE, len_wb, out, en, NW, L, stream);
}
