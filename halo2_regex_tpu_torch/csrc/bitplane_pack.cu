// K1: qpack -- [B, L] bytes -> class planes and enable plane.
//
// Replaces the TPU kernel BitplaneMatcher._make_qpack
// (halo2_regex_tpu/ops/bitplane.py:1138, pallas_call at :1229), in each of
// its modes: the class planes are binary or one-hot (the generated
// h2r_class), or, with the class stage off, the 8 byte-bit planes
// themselves (KP = 8); with en_pack off (H2R_EN_PACK 0) it writes no
// enable plane (en is a null pointer) and torch ops build it.
//
// What bounds it on the H100: by bytes, device memory -- it reads 1 B per
// input byte and writes (KP + 1) * 4 / 32 B per input byte (KP class
// planes plus the enable plane, 32 strings per word), about 16 us at
// B=32768 x L=1024 -- and, measured, the read of the strings' bytes: each
// tile reads strided pieces of 1024 rows, whose latency the bit work
// (the staging's byte permutes, the 8 x 8 bit transpose, the class
// circuit, the enable transpose) does not hide.
//
// Design: a block owns a tile of TW = 8 words x TL = 128 positions, i.e.
// the 256 strings g(w, beta) of those words, one 128-byte line of each.
// For a fixed beta % 8 = m, a word's strings are the four consecutive rows
// 4 * (w + NW * m) + s, s = 0..3, so warp m reads with each 16-byte load
// the whole 128-byte lines of one word's four strings (eight lanes a
// line); the L2 serves whole lines, not the 32-byte pieces of 16 lines
// that a 32-position tile asks for.  The rows land in shared memory as
// they are (raw, their words rotated by m, so the stores and the next
// phase's loads are free of bank conflicts); then each thread takes four
// strings' words at one 4-position group and turns the 4 x 4 block of
// bytes into the quad words of those positions (bytes s = 0..3 of the
// four strings at one position: what the bit planes are built from) with
// __byte_perm, into quad[p][8 m + wl].  The enable plane is built while
// the loads are in flight, from the lengths: lane beta of warp wl forms
// string beta's run mask over each 32 positions of the tile, (1 <<
// clamp(len - l0, 0, 32)) - 1, and one 32 x 32 bit transpose across the
// warp (five shuffle rounds) turns the 32 masks into that word's 32 enable
// words -- about one instruction a word and position where 32 compares
// against 32 lengths held in registers took three.  Then each thread
// computes one word at four positions: eight conflict-free shared loads,
// the SWAR 8 x 8 transpose (h2r_byte_planes), the class circuit
// (generated h2r_class), stores of 32-byte sectors.  Blocks take position
// tiles first, so those in flight read neighbouring lines.  Measured on
// the H100 (kernel_ab.py) with a 32 x 32 tile: a persistent grid whose
// blocks loaded their next tile into registers during the compute was
// slower than one tile a block (its 123 registers left two blocks an SM);
// the time hardly moved with the mode or with the L2 flushed, and without
// its byte loads the kernel took half the time: the loads of 32-byte
// pieces of 1 KiB-strided rows, not the bytes or the bit work, bound it.
//
// Layouts: chars [B, L] uint8; len_wb [NWS, 128, 32] int32 (length of
// string g(w, beta) at [w, beta]; unread with en_pack off); out [L, KP,
// NWS, 128] int32; en [NWS, L, 128] int32 (en_pack only).

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace {

constexpr int TW = 8;           // words per tile
constexpr int TL = 128;         // positions per tile: one 128-byte line of each string
constexpr int THREADS = 256;    // 8 warps: warp m loads the strings of beta % 8 == m
constexpr int NSTR = 32 * TW;   // strings of a tile
constexpr int RAWROW = TL / 4 + 1;  // words of a staged string row
constexpr int QROW = 8 * TW + 8;    // words of a staged position row
constexpr int EROW = TW;            // words of a staged enable row
constexpr int SMEM_BYTES = (NSTR * RAWROW + TL * QROW + TL * EROW) * 4;

// 16 bytes of a string row from position l, 0 past L.  VEC 2: 16-byte
// loads (L % 16 == 0, chars 16-byte aligned), 1: 4-byte loads (L % 4 ==
// 0, 4-byte aligned), 0: byte loads.
template <int VEC>
__device__ __forceinline__ void load16(const uint8_t* row, int l, int L, uint32_t* v) {
  if (VEC == 2) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (l < L) u = __ldg(reinterpret_cast<const uint4*>(row + l));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else if (VEC == 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[c] = l + 4 * c < L ? __ldg(reinterpret_cast<const uint32_t*>(row + l + 4 * c)) : 0u;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t x = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (l + 4 * c + t < L) x |= (uint32_t)__ldg(row + l + 4 * c + t) << (8 * t);
      v[c] = x;
    }
  }
}

// three blocks an SM; the byte loads' instance holds more bytes in flight
template <int VEC>
__global__ void __launch_bounds__(THREADS, VEC == 0 ? 2 : 3)
qpack_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ len_wb,
             int32_t* __restrict__ out, int32_t* __restrict__ en, int NW, int L) {
  extern __shared__ uint32_t smem[];
  // raw[r][c]: string r = 4 (8 m + wl) + s of the tile, positions 4c ..
  // 4c + 3 (the word index rotated by m); quad[p][8 m + wl]: bytes s =
  // 0..3 of those four strings at position p; ens[p][wl]: enable words
  uint32_t* raw = smem;
  uint32_t* quad = raw + NSTR * RAWROW;
  uint32_t* ens = quad + TL * QROW;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the tile: position tiles first, so the blocks in flight read whole
  // rows of the strings they share
  const int n_lt = (L + TL - 1) / TL;
  const int w0 = (blockIdx.x / n_lt) * TW, l0 = (blockIdx.x % n_lt) * TL;

  {  // A: warp m, lane (s, c) = (lane / 8, lane % 8): the 16 bytes from
     // position 16 c of string s of each of its eight words' quads, so a
     // load reads four whole 128-byte lines
    const int s = lane >> 3, c8 = lane & 7;
    auto row = [&](int wl) {  // string s of word w0 + wl's quad m = warp
      return chars + (4 * ((size_t)w0 + wl + (size_t)NW * warp) + s) * L;
    };
    auto stage = [&](int wl, const uint32_t* v) {
      uint32_t* r = raw + ((8 * warp + wl) * 4 + s) * RAWROW;
#pragma unroll
      for (int c = 0; c < 4; ++c) r[(4 * c8 + c + warp) & 31] = v[c];
    };
    uint32_t v[TW][4];
    if (VEC) {  // every load first
#pragma unroll
      for (int wl = 0; wl < TW; ++wl) load16<VEC>(row(wl), l0 + 16 * c8, L, v[wl]);
    }
#if H2R_EN_PACK
    {  // warp wl: word w0 + wl, lane beta its string beta, four 32-position runs
      const int len = __ldg(len_wb + (size_t)(w0 + warp) * 32 + lane);
#pragma unroll
      for (int t = 0; t < TL / 32; ++t) {
        const int n = min(max(len - l0 - 32 * t, 0), 32);  // lane's positions in the run
        const uint32_t run = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
        ens[(32 * t + lane) * EROW + warp] = h2r_warp_transpose32(run, lane);
      }
    }
#endif
    if (VEC) {
#pragma unroll
      for (int wl = 0; wl < TW; ++wl) stage(wl, v[wl]);
    } else {  // byte loads: one word's strings at a time, 16 loads each
#pragma unroll 1
      for (int wl = 0; wl < TW; ++wl) {
        load16<VEC>(row(wl), l0 + 16 * c8, L, v[0]);
        stage(wl, v[0]);
      }
    }
  }
  __syncthreads();
  {  // B: lane (m, wl) = (4 (warp % 2) + lane / 8, lane % 8) turns the four
     // strings' words at position groups 8 (warp / 2) .. + 7 into quad words
    const int m = 4 * (warp & 1) + (lane >> 3), wl = lane & 7;
    const uint32_t* rows = raw + (8 * m + wl) * 4 * RAWROW;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pg = 8 * (warp >> 1) + i;
      uint32_t x[4], o[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) x[s] = rows[s * RAWROW + ((pg + m) & 31)];
      h2r_bytes4x4(x, o);  // o[j]: bytes s = 0..3 of the strings at position 4 pg + j
#pragma unroll
      for (int j = 0; j < 4; ++j) quad[(4 * pg + j) * QROW + 8 * m + wl] = o[j];
    }
  }
  __syncthreads();

  // C: word w0 + lane % 8 at positions lane / 8 + 4 warp + 32 i (unrolled,
  // so the four positions' independent bit work interleaves)
  const int wl = lane & 7, w = w0 + wl;
#pragma unroll
  for (int i = 0; i < TL / 32; ++i) {
    const int p = (lane >> 3) + 4 * warp + 32 * i;
    const int l = l0 + p;
    if (l >= L) break;
    uint32_t q[8], bb[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) q[m] = quad[p * QROW + 8 * m + wl];
    h2r_byte_planes(q, bb);
    uint32_t cls[H2R_KP];
    h2r_class(bb, cls);
#pragma unroll
    for (int k = 0; k < H2R_KP; ++k)
      out[((size_t)l * H2R_KP + k) * NW + w] = (int32_t)cls[k];
#if H2R_EN_PACK
    const int nws = w / H2R_LANE, wlane = w % H2R_LANE;
    en[((size_t)nws * L + l) * H2R_LANE + wlane] = (int32_t)ens[p * EROW + wl];
#endif
  }
}

template <int VEC>
int launch(const void* chars, const void* len_wb, void* out, void* en, int B, int L,
           cudaStream_t st) {
  const int NW = B / 32;
  const int n_tiles = NW / TW * ((L + TL - 1) / TL);
  if (n_tiles == 0) return 0;
  // on every launch: the limit is a device's, and the call is cheap
  const cudaError_t attr = cudaFuncSetAttribute(
      qpack_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  qpack_kernel<VEC><<<n_tiles, THREADS, SMEM_BYTES, st>>>(
      (const uint8_t*)chars, (const int32_t*)len_wb, (int32_t*)out, (int32_t*)en, NW, L);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: 2 for 16-byte loads (L % 16 == 0 and chars 16-byte aligned), 1 for
// 4-byte loads (L % 4 == 0, 4-byte aligned), 0 for byte loads.
extern "C" int h2r_qpack(const void* chars, const void* len_wb, void* out, void* en,
                         int B, int L, int vec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec == 2) return launch<2>(chars, len_wb, out, en, B, L, st);
  if (vec == 1) return launch<1>(chars, len_wb, out, en, B, L, st);
  return launch<0>(chars, len_wb, out, en, B, L, st);
}
