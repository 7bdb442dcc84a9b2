// l4_pack and field_decode -- the emission and decode probes of tools/ as
// H100 kernels: one template, the transpose of byte-lane words to
// string-major l4-packed rows in four forms.
//
// l4_pack replaces probe_tpu48.py's kern_direct (pallas_call at :65) and
// probe_tpu64.py's kern_mxu (mkk, :161): words [A, M, L, 128] int32 ->
// rows [M, A, 512, L/4] int32, out[m, a] the rows of words[a, m]: row
// 4 * lane + s, column q holds byte lane s of lane `lane`'s words at
// positions 4q .. 4q + 3, position 4q + j in byte j (the port's
// ops/bitplane.py _l4_rows).  With A = NWS and M = 8 the output's bytes
// are probe_tpu48's [B, L] uint8 column, string order (m, nws, lane, s).
//
// field_decode replaces probe_tpu64.py's make_mxdecode (pallas_call at
// :316) and probe_tpu68.py's make_decode (:152): B14's function
// (ops/bitplane.py decode_plain) with the fields given at the call.  g4
// [NWS, 8G, L, 128] (group gi's word b at plane 8 gi + b) and the chars
// ch [B, L/4] -> [n_fields + 1, B, L/4] int32: field f (group gi, first
// bit off, nb bits) is (rows >> off) & ((2^nb - 1) * 0x01010101) of its
// group's rows, row 512 * (b * NWS + nws) + 4 * lane + s; the last array
// is ch & 0xFF in every byte whose field-0 (flags) bit 0 is set.
//
// The forms (the transpose of one group's tile of positions x 128 lanes):
//   PERMUTE    (l4_pack; B14's design, csrc/bitplane_decode.cu) a thread a
//              lane reads its 4 words of each column from device memory,
//              transposes the 4 x 4 byte block with byte permutes into a
//              shared tile of rows, and the block writes the rows.
//   SWAP       the int32 tile transpose: the block stages the tile in
//              shared memory (pitch 129 words), a thread reads the 4 words
//              of a column of one lane (the transposed read), then packs
//              the four columns by shifts and masks (probe_tpu68's "sw").
//   MMA_PACK   the tensor cores: mma.sync.m16n8k16, bf16 x bf16 -> f32, A
//              the byte lane s of a warp's 16 lanes x 16 positions (rows
//              lanes, k positions), B the packing matrix of probe_tpu64.py
//              :104-115 (weights 1 and 256: lo and hi halfwords), the word
//              lo | hi << 16.
//   MMA_SELECT the same with probe_tpu68.py:90-98's selector (one nonzero
//              a column), the four 8-bit groups shifted and OR-ed.
// A 16-position k-tile feeds 4 output columns, so of the probes' [128,
// 64] or [128, 128] constant only the 16 x 8 blocks that hold a nonzero
// are multiplied: 2 (pack) or 4 (select) n-tiles a k-tile, a quarter of
// the dense product's mma for the selector, half for the packing matrix.
// The fragments are built in registers: a byte to bf16 is one byte
// permute (the byte into 0x4B0000xx) and one float add, exact; every
// product is exact in f32 (a packing sum is at most 255 + 256 * 255 =
// 65535, a selector sum has one nonzero term), and the sums come back to
// integers the same way.  The A fragments are read straight from device
// memory: a warp load covers 4 positions x 8 lanes, four whole 32-byte
// sectors.  A block of the mma forms takes 32 positions, and a thread
// issues all its loads (16 words, and 16 chars where it writes the masked
// characters) before its first product: over 64 positions, or with the
// chars loaded as each byte lane is written, the loads wait in turn
// (PERF.md §6).
//
// What bounds it on the H100: device-memory bytes (the words in, the rows
// out; field_decode also reads the chars and writes n_fields + 1 arrays:
// at the from: batch, B=32768 x L=1024, G = 2 and 3 fields, 64 + 32 + 128
// MiB, as B14).  The mma forms' tensor-core work is under a tenth of that
// time at the dense bf16 rate.
//
// Grid: (A * M / G cells, L / positions position tiles, G groups); a
// block transposes one group of its cell (field_decode: a (b, nws) cell,
// the probes' grid cell) and writes the group's fields, and the masked
// characters where the group holds the flags (their chars read ahead of
// the transpose).  The first design ran a cell's groups in one block, one
// after the other, and read the chars as it wrote, and lost to B14 in
// every form (PERF.md §6); SWAP keeps 64 positions (over 32 it is slower,
// PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

#include "bitplane_common.cuh"  // h2r_bytes4x4, B14's 4 x 4 byte transpose

namespace {

constexpr int LANE = 128;
constexpr int ROWS = 4 * LANE;   // rows of an output plane
constexpr int TP = 64;           // positions a block: L is a multiple of it
constexpr int TQ = TP / 4;       // output columns a block (PERMUTE)
constexpr int MAXF = 8;          // fields at most
constexpr int WIDE = 256;        // threads of the SWAP and MMA blocks
constexpr int TPS = 64;          // positions a SWAP block

enum Form { PERMUTE = 0, SWAP = 1, MMA_PACK = 2, MMA_SELECT = 3 };

// positions a block of each form: the mma forms take 32, so that a
// thread's words and chars are all in flight at once
template <int FORM>
__host__ __device__ constexpr int positions() {
  return FORM == PERMUTE ? TP : FORM == SWAP ? TPS : 32;
}

struct Fields {
  int n;                // field 0 is the flags field: its bit 0 is the mask
  int gi[MAXF];         // group
  int off[MAXF];        // first bit
  uint32_t mask[MAXF];  // (2^nb - 1) * 0x01010101
};

struct Geo {
  int32_t* out;       // the cell's plane of field 0; field f at + f * fstride
  size_t fstride;
  const int32_t* ch;  // the cell's chars (field_decode)
  int l4;
};

template <int N>
__device__ __forceinline__ void store(int32_t* p, const uint32_t (&v)[N]) {
  if constexpr (N == 1) *p = (int32_t)v[0];
  else *(uint2*)p = make_uint2(v[0], v[1]);
}

template <int N>
__device__ __forceinline__ void load(const int32_t* p, uint32_t (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = (uint32_t)__ldg(p);
  } else {
    const uint2 x = __ldg((const uint2*)p);
    v[0] = x.x;
    v[1] = x.y;
  }
}

// words v of row `row`, columns q .. q + N - 1, of group gi's rows: every
// field of the group and, with mc (the block's group holds field 0, the
// flags), the masked characters from the chars c read ahead
template <int N>
__device__ __forceinline__ void put(const Geo& geo, const Fields& fl, int gi, int row, int q,
                                    const uint32_t (&v)[N], bool mc, const uint32_t (&c)[N]) {
  const size_t at = (size_t)row * geo.l4 + q;
  for (int f = 0; f < fl.n; ++f) {
    if (fl.gi[f] != gi) continue;
    uint32_t o[N];
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = (v[k] >> fl.off[f]) & fl.mask[f];
    store<N>(geo.out + f * geo.fstride + at, o);
    if (f == 0 && mc) {
#pragma unroll
      for (int k = 0; k < N; ++k) o[k] = c[k] & ((o[k] & 0x01010101u) * 255u);
      store<N>(geo.out + fl.n * geo.fstride + at, o);
    }
  }
}

// the chars of row `row`, columns q .. q + N - 1 (zero unless mc)
template <int N>
__device__ __forceinline__ void chars(const Geo& geo, bool mc, int row, int q, uint32_t (&c)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] = 0;
  if (mc) load<N>(geo.ch + (size_t)row * geo.l4 + q, c);
}

// byte s of two words as a pair of bf16 (lo in the low half), exact:
// 0x4B0000xx is the float 2^23 + xx, and xx < 256 keeps the bf16 bits
__device__ __forceinline__ uint32_t bf16x2_bytes(uint32_t lo, uint32_t hi, int s) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | s)) - 8388608.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | s)) - 8388608.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// an exact integer sum below 2^16 back to its bits
__device__ __forceinline__ uint32_t ubits(float x) { return __float_as_uint(x + 8388608.f); }

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the constant's nonzero 16 x 8 block (h, x) at row i, column n (bf16
// bits): x is the byte r of the selector's group, or the packing matrix's
// half (0 lo, 1 hi); k-tile 2j + h feeds columns 4h .. 4h + 3 of the
// pair's n-tile
template <int FORM>
__device__ __forceinline__ uint32_t bval(int i, int n, int h, int x) {
  if (n != 4 * h + i / 4) return 0u;
  if constexpr (FORM == MMA_SELECT) return i % 4 == x ? 0x3F80u : 0u;  // 1.0
  return (i % 4) / 2 == x ? ((i & 1) ? 0x4380u : 0x3F80u) : 0u;        // 256.0, 1.0
}

// B fragment (m16n8k16, bf16) of block (h, x) for lane (g, t): rows 2t,
// 2t + 1 and 2t + 8, 2t + 9, column g
template <int FORM>
__device__ __forceinline__ uint2 bfrag(int h, int x, int g, int t) {
  return make_uint2(bval<FORM>(2 * t, g, h, x) | bval<FORM>(2 * t + 1, g, h, x) << 16,
                    bval<FORM>(2 * t + 8, g, h, x) | bval<FORM>(2 * t + 9, g, h, x) << 16);
}

constexpr int SPLANE = LANE * (TQ + 1) + 16;  // PERMUTE: words a byte lane s of the row tile

template <int FORM, bool MC>
__global__ void __launch_bounds__(FORM == PERMUTE ? LANE : WIDE)
emit_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ ch,
            int32_t* __restrict__ out, const __grid_constant__ Fields fl, int A, int Mg, int G,
            int L) {
  const int cell = blockIdx.x, a = cell % A, b = cell / A, gi = blockIdx.z;
  const int l0 = blockIdx.y * positions<FORM>(), q0 = l0 / 4;
  const size_t plane = (size_t)L * LANE;  // words of an input plane and of an output plane
  Geo geo;
  geo.out = out + (size_t)cell * plane;
  geo.fstride = (size_t)A * Mg * plane;
  geo.ch = MC ? ch + (size_t)cell * plane : nullptr;
  geo.l4 = L / 4;
  const int32_t* src = w + (((size_t)a * G + gi) * Mg + b) * plane + (size_t)l0 * LANE;
  const bool mc = MC && fl.gi[0] == gi;

  if constexpr (FORM == PERMUTE) {
    // rows grouped by byte lane s, pitch TQ + 1, 16 words between groups:
    // the column writes (lanes 17 words apart) and the row reads (2 rows
    // of a warp, 16 banks apart) are conflict-free
    __shared__ uint32_t tile[4 * SPLANE];
    const int lane = threadIdx.x;
#pragma unroll 4
    for (int qq = 0; qq < TQ; ++qq) {
      uint32_t v[4], o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = (uint32_t)__ldg(src + (size_t)(4 * qq + j) * LANE + lane);
      h2r_bytes4x4(v, o);
#pragma unroll
      for (int s = 0; s < 4; ++s) tile[s * SPLANE + lane * (TQ + 1) + qq] = o[s];
    }
    __syncthreads();
    const int qq = threadIdx.x % TQ;
    for (int r = threadIdx.x / TQ; r < ROWS; r += LANE / TQ) {
      uint32_t c[1];
      chars<1>(geo, mc, r, q0 + qq, c);
      const uint32_t x[1] = {tile[(r % 4) * SPLANE + (r / 4) * (TQ + 1) + qq]};
      put<1>(geo, fl, gi, r, q0 + qq, x, mc, c);
    }
  } else if constexpr (FORM == SWAP) {
    constexpr int NQ = TPS / 32;  // 8-column groups a block
    __shared__ uint32_t tile[TPS * (LANE + 1)];
    const int wl = threadIdx.x & 31;
#pragma unroll 8
    for (int i = threadIdx.x; i < TPS * LANE; i += WIDE)
      tile[(i / LANE) * (LANE + 1) + i % LANE] = (uint32_t)__ldg(src + i);
    __syncthreads();
    // item (lane ln, column qq): a warp holds 4 lanes x 8 columns, so the
    // column reads (banks 4 qq + ln + j) are conflict-free
#pragma unroll 2
    for (int p = 0; p < TPS / 4 * LANE / WIDE; ++p) {
      const int sl = (p * WIDE + threadIdx.x) >> 5;
      const int qq = 8 * (sl % NQ) + (wl & 7), ln = 4 * (sl / NQ) + (wl >> 3);
      uint32_t c[4][1], t[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) chars<1>(geo, mc, 4 * ln + s, q0 + qq, c[s]);
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = tile[(4 * qq + j) * (LANE + 1) + ln];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t x[1] = {((t[0] >> (8 * s)) & 255u) | (((t[1] >> (8 * s)) & 255u) << 8) |
                               (((t[2] >> (8 * s)) & 255u) << 16) | ((t[3] >> (8 * s)) << 24)};
        put<1>(geo, fl, gi, 4 * ln + s, q0 + qq, x, mc, c[s]);
      }
    }
  } else {
    // a warp a m-tile of 16 lanes; k-tiles of 16 positions in pairs (h =
    // 0, 1), a pair's 8 output columns in one n-tile a group (selector
    // byte r, or packing half); every word and char of the tile is
    // loaded first
    constexpr int NX = FORM == MMA_SELECT ? 4 : 2;
    constexpr int NJ = positions<FORM>() / 32;
    const int wl = threadIdx.x & 31, g = wl >> 2, t = wl & 3;
    const int m0 = 16 * (threadIdx.x >> 5);
    const int ko[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
    uint32_t wv[NJ][2][4][2];  // [pair j][h][row k of ko][lane g, g + 8]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            wv[j][h][k][e] =
                (uint32_t)__ldg(src + (size_t)(32 * j + 16 * h + ko[k]) * LANE + m0 + g + 8 * e);
    uint2 bf[2][NX];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < NX; ++x) bf[h][x] = bfrag<FORM>(h, x, g, t);
    uint32_t cc[NJ][4][2][2];  // the chars: [j][s][row of lane g, g + 8][2 columns]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        chars<2>(geo, mc, 4 * (m0 + g) + s, q0 + 8 * j + 2 * t, cc[j][s][0]);
        chars<2>(geo, mc, 4 * (m0 + g + 8) + s, q0 + 8 * j + 2 * t, cc[j][s][1]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int q = q0 + 8 * j + 2 * t;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t(&c_lo)[2] = cc[j][s][0];
        const uint32_t(&c_hi)[2] = cc[j][s][1];
        float acc[NX][4];
#pragma unroll
        for (int x = 0; x < NX; ++x) acc[x][0] = acc[x][1] = acc[x][2] = acc[x][3] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t af[4] = {bf16x2_bytes(wv[j][h][0][0], wv[j][h][1][0], s),
                                  bf16x2_bytes(wv[j][h][0][1], wv[j][h][1][1], s),
                                  bf16x2_bytes(wv[j][h][2][0], wv[j][h][3][0], s),
                                  bf16x2_bytes(wv[j][h][2][1], wv[j][h][3][1], s)};
#pragma unroll
          for (int x = 0; x < NX; ++x) mma_bf16(acc[x], af, bf[h][x]);
        }
        // accumulator c of acc[x]: lane g (c < 2) or g + 8, column 2t + c % 2
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (FORM == MMA_SELECT) {
            const uint32_t u0 = __byte_perm(ubits(acc[0][e]), ubits(acc[1][e]), 0x0040);
            const uint32_t u1 = __byte_perm(ubits(acc[2][e]), ubits(acc[3][e]), 0x0040);
            const uint32_t v0 = __byte_perm(ubits(acc[0][2 + e]), ubits(acc[1][2 + e]), 0x0040);
            const uint32_t v1 = __byte_perm(ubits(acc[2][2 + e]), ubits(acc[3][2 + e]), 0x0040);
            lo[e] = __byte_perm(u0, u1, 0x5410);
            hi[e] = __byte_perm(v0, v1, 0x5410);
          } else {
            lo[e] = __byte_perm(ubits(acc[0][e]), ubits(acc[1][e]), 0x5410);
            hi[e] = __byte_perm(ubits(acc[0][2 + e]), ubits(acc[1][2 + e]), 0x5410);
          }
        }
        put<2>(geo, fl, gi, 4 * (m0 + g) + s, q, lo, mc, c_lo);
        put<2>(geo, fl, gi, 4 * (m0 + g + 8) + s, q, hi, mc, c_hi);
      }
    }
  }
}

template <int FORM, bool MC>
int launch(const void* w, const void* ch, void* out, const Fields& fl, int A, int Mg, int G,
           int L, cudaStream_t st) {
  const dim3 grid(A * Mg, L / positions<FORM>(), G);
  emit_kernel<FORM, MC><<<grid, FORM == PERMUTE ? LANE : WIDE, 0, st>>>(
      (const int32_t*)w, (const int32_t*)ch, (int32_t*)out, fl, A, Mg, G, L);
  return (int)cudaGetLastError();
}

}  // namespace

// words [A, M, L, 128] int32 -> rows [M, A, 512, L/4]; form 0 permute,
// 1 swap, 2 mma_pack, 3 mma_select; L a multiple of 64; out 8-byte aligned
extern "C" int h2r_l4_pack(const void* words, void* out, int A, int M, int L, int form,
                           void* stream) {
  if (A <= 0 || M <= 0 || L <= 0 || L % TP || L / 32 > 65535 || ((uintptr_t)out & 7))
    return (int)cudaErrorInvalidValue;
  Fields fl{};
  fl.n = 1;
  fl.mask[0] = 0xFFFFFFFFu;
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case PERMUTE: return launch<PERMUTE, false>(words, nullptr, out, fl, A, M, 1, L, st);
    case SWAP: return launch<SWAP, false>(words, nullptr, out, fl, A, M, 1, L, st);
    case MMA_PACK: return launch<MMA_PACK, false>(words, nullptr, out, fl, A, M, 1, L, st);
    case MMA_SELECT: return launch<MMA_SELECT, false>(words, nullptr, out, fl, A, M, 1, L, st);
  }
  return (int)cudaErrorInvalidValue;
}

// g4 [NWS, 8G, L, 128] int32, ch [NWS * 4096, L/4] int32 -> out
// [n_fields + 1, NWS * 4096, L/4]; fields: host ints (group, first bit,
// bit count) a field, field 0 the flags; form 1 swap, 2 mma_pack,
// 3 mma_select; L a multiple of 64; ch and out 8-byte aligned
extern "C" int h2r_field_decode(const void* g4, const void* ch, void* out, const int* fields,
                                int n_fields, int NWS, int G, int L, int form, void* stream) {
  if (NWS <= 0 || G <= 0 || L <= 0 || L % TP || L / 32 > 65535 || n_fields < 1 ||
      n_fields > MAXF || (((uintptr_t)ch | (uintptr_t)out) & 7))
    return (int)cudaErrorInvalidValue;
  Fields fl{};
  fl.n = n_fields;
  for (int f = 0; f < n_fields; ++f) {
    const int gi = fields[3 * f], off = fields[3 * f + 1], nb = fields[3 * f + 2];
    if (gi < 0 || gi >= G || off < 0 || nb < 1 || off + nb > 8) return (int)cudaErrorInvalidValue;
    fl.gi[f] = gi;
    fl.off[f] = off;
    fl.mask[f] = ((1u << nb) - 1u) * 0x01010101u;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case SWAP: return launch<SWAP, true>(g4, ch, out, fl, NWS, 8, G, L, st);
    case MMA_PACK: return launch<MMA_PACK, true>(g4, ch, out, fl, NWS, 8, G, L, st);
    case MMA_SELECT: return launch<MMA_SELECT, true>(g4, ch, out, fl, NWS, 8, G, L, st);
  }
  return (int)cudaErrorInvalidValue;
}
