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
// 128, s_l = 128).  Either way the 128 words of one (nws, m, l) are one
// contiguous 512-byte piece.
//
// Design: a block owns a tile of 32 words (one 128-byte line of each
// piece) x 32 positions, grid (word groups, position tiles): B=32768 x
// L=1024 gives 1024 blocks, B=4096 gives 128, and each SM holds four or
// five (36 KiB of shared memory, at most 64 registers), so while one
// block computes, the others' copies are in flight.  The tile's 256
// pieces go to shared memory by 16-byte cp.async copies (4-byte copies
// where the quads are not 16-byte aligned), issued before anything else
// in two commit groups of 16 positions: the enable words are built while
// they fly, and the first 16 positions are computed while the second
// group's copies land.  Warp wp computes the tile's 32 words at
// positions wp + 8 u (u = 0..3), lane = word: eight conflict-free shared
// loads, the SWAR 8 x 8 transpose (h2r_byte_planes), the class circuit
// (h2r_class), and stores of whole 128-byte lines.  (Measured on the
// H100, kernel_ab.py: a persistent grid whose blocks took several tiles
// through a two-stage ring was slower than one tile a block, 0.0305
// against 0.0276 ms.)
//
// The enable plane, K1's way: while the copies are in flight, warp wp
// takes words 4 wp .. 4 wp + 3 of the tile; lane beta loads the
// length of string beta (coalesced), forms its run mask over the tile's
// 32 positions, (1 << clamp(len - l0, 0, 32)) - 1, and one 32 x 32 warp
// bit transpose (five shuffle rounds) leaves in lane p the word's enable
// word at position l0 + p, staged in shared memory for the lanes that
// store it.  No thread holds 32 lengths or makes 32 compares a word.
// Positions past L are never read or written; past a string's length its
// enable bits are 0 (every length is <= L).
//
// Outputs: out [L_pad, KP, NWS, 128] int32; en [NWS, L_pad, 128] int32;
// len_wb [NWS, 128, 32] int32.
#pragma once

namespace {

constexpr int kPwTW = 32;                // words a tile
constexpr int kPwTP = 32;                // positions a tile
constexpr int kPwThreads = 256;          // 8 warps
constexpr int kPwRow = 8 * kPwTW;        // words of a staged position: 8 pieces
constexpr int kPwERow = kPwTW + 1;       // words of a staged enable row (padded)
constexpr int kPwSmem = (kPwTP * kPwRow + kPwTP * kPwERow) * 4;  // 36,992 bytes
constexpr int kPwGroups = 2;               // copy groups a tile
constexpr int kPwGP = kPwTP / kPwGroups;   // positions a group
static_assert(kPwGP % 8 == 0 && kPwGroups <= 4, "a group is whole rows of every warp");

template <int BYTES>
__device__ __forceinline__ void pw_cp_async(unsigned dst, const int32_t* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

template <int N>  // until at most N commit groups are in flight
__device__ __forceinline__ void pw_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// V16: 16-byte copies (the quads 16-byte aligned), else 4-byte copies
template <bool V16>
__global__ void __launch_bounds__(kPwThreads, 4)
pack_words_kernel(const int32_t* __restrict__ quads, long long s_nws, long long s_m,
                  long long s_l, const int32_t* __restrict__ len_wb,
                  int32_t* __restrict__ out, int32_t* __restrict__ en, int NW, int L) {
  extern __shared__ uint32_t smem[];
  uint32_t* ens = smem + kPwTP * kPwRow;  // ens[p][w]: the tile's enable words
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int w0 = blockIdx.x * kPwTW, l0 = blockIdx.y * kPwTP;
  const int nws = w0 / H2R_LANE, lane0 = w0 % H2R_LANE;
  const unsigned st = (unsigned)__cvta_generic_to_shared(smem);

  // piece (p, m) of the tile to p * kPwRow + m * 32, the positions of
  // each group in a commit group of their own
  const int32_t* src = quads + nws * s_nws + l0 * s_l + lane0;
  // V16: thread = piece m = tid / 8 % 8, 16 bytes c = tid % 8, positions
  // tid / 64 + 4 i; else warp m, lane = word, every position
  const int m = V16 ? tid / 8 % 8 : warp, c = V16 ? tid % 8 : 0, p0 = V16 ? tid / 64 : 0;
  const int32_t* g = src + p0 * s_l + m * s_m + (V16 ? 4 * c : lane);
  const unsigned d = st + (p0 * kPwRow + m * kPwTW + (V16 ? 4 * c : lane)) * 4;
#pragma unroll
  for (int gr = 0; gr < kPwGroups; ++gr) {
    if (V16) {
#pragma unroll
      for (int i = gr * kPwGP / 4; i < (gr + 1) * kPwGP / 4; ++i)
        if (l0 + p0 + 4 * i < L) pw_cp_async<16>(d + 4 * i * kPwRow * 4, g + 4 * i * s_l);
    } else {
#pragma unroll 8
      for (int p = gr * kPwGP; p < (gr + 1) * kPwGP; ++p)
        if (l0 + p < L) pw_cp_async<4>(d + p * kPwRow * 4, g + p * s_l);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#if H2R_EN_PACK
#pragma unroll
  for (int i = 0; i < kPwTW / 8; ++i) {  // word 4 warp + i, lane = string
    const int kk = (kPwTW / 8) * warp + i;
    const int len = __ldg(len_wb + ((size_t)w0 + kk) * 32 + lane);
    const int n = min(max(len - l0, 0), 32);  // the lane's positions in the tile
    const uint32_t run = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
    ens[lane * kPwERow + kk] = h2r_warp_transpose32(run, lane);
  }
#endif
  // each group's positions once its copies have landed, while the later
  // groups' are in flight
#pragma unroll
  for (int gr = 0; gr < kPwGroups; ++gr) {
    const int later = kPwGroups - 1 - gr;
    if (later == 0) pw_wait<0>();
    else if (later == 1) pw_wait<1>();
    else if (later == 2) pw_wait<2>();
    else pw_wait<3>();
    __syncthreads();
#pragma unroll
    for (int u = gr * kPwGP / 8; u < (gr + 1) * kPwGP / 8; ++u) {
      const int p = warp + 8 * u, l = l0 + p;
      if (l >= L) break;
      uint32_t q[8], bb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = smem[p * kPwRow + k * kPwTW + lane];
      h2r_byte_planes(q, bb);
      uint32_t cls[H2R_KP];
      h2r_class(bb, cls);
      int32_t* o = out + (size_t)l * H2R_KP * NW + w0 + lane;
#pragma unroll
      for (int kp = 0; kp < H2R_KP; ++kp) o[(size_t)kp * NW] = (int32_t)cls[kp];
#if H2R_EN_PACK
      en[((size_t)nws * L + l) * H2R_LANE + lane0 + lane] = (int32_t)ens[p * kPwERow + lane];
#endif
    }
  }
}

inline int h2r_pack_words(const void* quads, long long s_nws, long long s_m, long long s_l,
                          const void* len_wb, void* out, void* en, int NW, int L,
                          void* stream) {
  const dim3 grid(NW / kPwTW, (L + kPwTP - 1) / kPwTP);
  if (grid.x == 0 || grid.y == 0) return 0;
  auto kernel = (size_t)quads % 16 == 0 ? pack_words_kernel<true> : pack_words_kernel<false>;
  kernel<<<grid, kPwThreads, kPwSmem, (cudaStream_t)stream>>>(
      (const int32_t*)quads, s_nws, s_m, s_l, (const int32_t*)len_wb, (int32_t*)out,
      (int32_t*)en, NW, L);
  return (int)cudaGetLastError();
}

}  // namespace
