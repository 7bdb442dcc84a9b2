// B14: decode -- the kdecode witness emission's field decode: the post
// kernel's byte-group words -> every field as a string-major l4-packed
// int32 array, whose [B, L] uint8 column is a view, plus the masked
// characters.
//
// Replaces the TPU kernel BitplaneMatcher._make_decode
// (halo2_regex_tpu/ops/bitplane.py:1666, pallas_call at :1700), the tail of
// emit="kdecode": K3 in bytes mode (with the boundary planes), then this
// kernel in place of the torch decode of emit="bytes".
//
// Computes, per field f (group gi, first bit off, nb bits) and byte-group
// word b of word w = (nws, lane) at position l:
//     v = (word >> off) & ((2^nb - 1) * 0x01010101),
// whose byte lane s is string 4 * (w + NW * b) + s, i.e. row
//     512 * (b * NWS + nws) + 4 * lane + s
// of the [B, L/4] int32 output, byte l % 4 of column l / 4.  The last
// output is chars & 0xFF in every byte whose flags bit 0 (the mask) is
// set: the masked characters.
//
// What bounds it on the H100: device-memory bytes.  It reads the 8 G
// byte-group planes and the [B, L] chars and writes (n_fields + 1) [B, L]
// byte arrays: at B=32768 x L=1024 for the from: model (G = 2, 3 fields)
// 64 + 32 + 128 MiB.  The per-word work is a few shifts, masks and byte
// permutes.
//
// Design: a block is one (b, nws) cell's 128 lanes (the JAX grid cell) and
// a tile of QT output columns (4 * QT positions), and transposes through
// shared memory, as the TPU kernel transposed in VMEM.  Per field, each
// thread reads its lane's words of the tile's positions (coalesced over
// lanes), decodes the field, transposes each 4 x 4 block of bytes (4
// positions x 4 strings) with byte permutes and writes the 4 row words
// into the tile; then the block writes the tile's 512 rows, QT consecutive
// int32 (32 bytes: one full sector) each, 4 rows per warp store.  The
// masked characters are written beside the flags field, which is the
// first: their chars are read row-wise in the same coalesced pattern.
// The tile's rows are grouped by byte lane s with a pitch of QT + 1 words
// and 8 words between the groups, so neither the column writes (lanes
// 9 words apart) nor the row reads (4 rows of one warp in 4 bank groups)
// conflict.  Stored straight to global memory, a warp's row words would
// touch 32 rows 1 KiB apart per store.
//
// Layouts: g4 [NWS, 8 * NGROUPS, L, 128] int32; ch [B, L/4] int32 (the
// chars' bytes, L padded to L_pad); out [NFIELDS + 1, B, L/4] int32.

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int THREADS = H2R_LANE;                // one thread per lane
constexpr int QT = 8;                            // output columns per block
constexpr int PITCH = QT + 1;                    // words per tile row
constexpr int SPLANE = H2R_LANE * PITCH + 8;     // words per byte lane s
constexpr int ROWS = 4 * H2R_LANE;               // rows per (b, nws) cell

__global__ void __launch_bounds__(THREADS)
decode_kernel(const int32_t* __restrict__ g4, const int32_t* __restrict__ ch,
              int32_t* __restrict__ out, int NWS, int L) {
  __shared__ uint32_t tile[4 * SPLANE];
  const int b = blockIdx.x / NWS, nws = blockIdx.x % NWS;
  const int lane = threadIdx.x;
  const int l4 = L / 4, q0 = blockIdx.y * QT;
  const int nq = min(QT, l4 - q0);
  const size_t plane = (size_t)L * H2R_LANE;
  const size_t B = (size_t)NWS * 32 * H2R_LANE;
  // group gi's word b of this lane at position l: g_base[gi * 8 * plane + l * 128]
  const int32_t* g_base = g4 + ((size_t)nws * 8 * H2R_NGROUPS + b) * plane + lane;
  const size_t row0 = (size_t)ROWS * ((size_t)b * NWS + nws);
#pragma unroll
  for (int f = 0; f < H2R_NFIELDS; ++f) {
    // the tile's columns of field f: this lane's 4 rows
    for (int qq = 0; qq < nq; ++qq) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t gw[H2R_NGROUPS], fw[H2R_NFIELDS];
#pragma unroll
        for (int gi = 0; gi < H2R_NGROUPS; ++gi)
          gw[gi] = (uint32_t)__ldg(g_base + gi * 8 * plane + (size_t)(4 * (q0 + qq) + j) * H2R_LANE);
        h2r_decode_fields(gw, fw);
        v[j] = fw[f];
      }
      uint32_t o[4];
      h2r_bytes4x4(v, o);
#pragma unroll
      for (int s = 0; s < 4; ++s) tile[s * SPLANE + lane * PITCH + qq] = o[s];
    }
    __syncthreads();
    // the tile's rows: thread t writes column t % QT of rows t / QT + 16 i
    const int qq = threadIdx.x % QT;
    if (qq < nq) {
      const size_t q = q0 + qq;
      for (int r = threadIdx.x / QT; r < ROWS; r += THREADS / QT) {
        const uint32_t w = tile[(r % 4) * SPLANE + (r / 4) * PITCH + qq];
        const size_t row = row0 + r;
        out[((size_t)f * B + row) * l4 + q] = (int32_t)w;
        if (f == H2R_FLAGS_FIELD)  // the masked characters: chars where the mask is set
          out[((size_t)H2R_NFIELDS * B + row) * l4 + q] =
              (int32_t)((uint32_t)__ldg(ch + row * l4 + q) & ((w & 0x01010101u) * 255u));
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int h2r_decode(const void* g4, const void* ch, void* out, int NWS, int L,
                          void* stream) {
  const dim3 grid(8 * NWS, (L / 4 + QT - 1) / QT);
  decode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)g4, (const int32_t*)ch, (int32_t*)out, NWS, L);
  return (int)cudaGetLastError();
}
