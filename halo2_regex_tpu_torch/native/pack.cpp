// Host corpus packers of the port: the corpus loader's line packer and the
// tiled input contract's quad-word packer.  Copies of h2r_pack_lines and
// h2r_tile_corpus from halo2_regex_tpu/native/scan.cpp (the port carries
// its own copy; the JAX package's native module is not imported), with a
// C ABI for ctypes.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Corpus packer: split a newline-delimited buffer into a padded batch.
// Pass 1 (count_only=1): returns the number of lines; out buffers unused.
// Pass 2: fills chars_out [n, max_len] and lengths_out [n]; lines longer
// than max_len are truncated (truncated count returned via *n_truncated).
// keep_newline restores each terminated line's '\n' byte (lines split on
// '\n'; the final unterminated line is unchanged): the email-header DFAs
// need the full \r\n ending to reach their accept state.
int64_t h2r_pack_lines(const uint8_t* data, int64_t data_len, int64_t max_len,
                       int32_t count_only, uint8_t* chars_out,
                       int32_t* lengths_out, int64_t* n_truncated,
                       int32_t keep_newline) {
  // Block-local newline counts -> exclusive scan -> block-parallel
  // position fill -> line-parallel copy.
  const int64_t BLK = 1 << 20;
  const int64_t n_blk = data_len > 0 ? (data_len + BLK - 1) / BLK : 0;
  std::vector<int64_t> counts(n_blk + 1, 0);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blk; ++b) {
    const uint8_t* p = data + b * BLK;
    const uint8_t* end = data + std::min(data_len, (b + 1) * BLK);
    int64_t c = 0;
    while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
      ++c;
      ++p;
    }
    counts[b + 1] = c;
  }
  for (int64_t b = 0; b < n_blk; ++b) counts[b + 1] += counts[b];
  int64_t n_nl = n_blk ? counts[n_blk] : 0;
  // final unterminated line (buffer not ending in '\n') is one more row
  bool tail_line = data_len > 0 && data[data_len - 1] != '\n';
  int64_t n = n_nl + (tail_line ? 1 : 0);
  if (count_only) return n;

  std::vector<int64_t> nl_pos(n_nl);
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < n_blk; ++b) {
    const uint8_t* base = data;
    const uint8_t* p = data + b * BLK;
    const uint8_t* end = data + std::min(data_len, (b + 1) * BLK);
    int64_t w = counts[b];
    while ((p = (const uint8_t*)memchr(p, '\n', end - p)) != nullptr) {
      nl_pos[w++] = p - base;
      ++p;
    }
  }

  int64_t truncated = 0;
#pragma omp parallel for schedule(static) reduction(+ : truncated)
  for (int64_t r = 0; r < n; ++r) {
    int64_t start = r == 0 ? 0 : nl_pos[r - 1] + 1;
    bool terminated = r < n_nl;
    int64_t stop = terminated ? nl_pos[r] : data_len;
    int64_t len = stop - start;
    if (keep_newline && terminated) ++len;  // the '\n' at data[stop]
    int64_t copy = len < max_len ? len : max_len;
    if (len > max_len) ++truncated;
    std::memcpy(chars_out + r * max_len, data + start, copy);
    std::memset(chars_out + r * max_len + copy, 0, max_len - copy);
    lengths_out[r] = (int32_t)copy;
  }
  if (n_truncated) *n_truncated = truncated;
  return n;
}

// Host-side packer for the tiled input contract (ops/bitplane.py
// tile_corpus): [B, L] uint8 chars -> [NWS, 8, L_pad, LANE(=128)] int32
// quad words, T[nws][m][l][lane] packing bytes s=0..3 of strings
// g = 4*((nws*128+lane) + NW*m) + s at position l (NW = NWS*128).
// B may be short of NWS*4096 and L short of L_pad; the tail reads as
// zero bytes.  Parallel over (nws, m); each (lane-block, l-block) tile
// stays in L1 so neither the strided reads nor the strided writes leave
// cache unmerged.
void h2r_tile_corpus(const uint8_t* chars, int64_t B, int64_t L,
                     int64_t L_pad, int64_t NWS, int32_t* out) {
  const int64_t LANE = 128;
  const int64_t NW = NWS * LANE;
  const int64_t LB = 128;  // l-block: 128*LANE*4B = 64 KB tile
#pragma omp parallel for schedule(static) collapse(2)
  for (int64_t nws = 0; nws < NWS; ++nws) {
    for (int64_t m = 0; m < 8; ++m) {
      int32_t* dst = out + ((nws * 8 + m) * L_pad) * LANE;
      for (int64_t l0 = 0; l0 < L_pad; l0 += LB) {
        int64_t l1 = std::min(l0 + LB, L_pad);
        for (int64_t lane = 0; lane < LANE; ++lane) {
          int64_t g = 4 * ((nws * LANE + lane) + NW * m);
          if (g + 3 < B) {
            const uint8_t* r0 = chars + (g + 0) * L;
            const uint8_t* r1 = chars + (g + 1) * L;
            const uint8_t* r2 = chars + (g + 2) * L;
            const uint8_t* r3 = chars + (g + 3) * L;
            for (int64_t l = l0; l < l1; ++l) {
              int32_t w = 0;
              if (l < L) {
                w = (int32_t)r0[l] | ((int32_t)r1[l] << 8) |
                    ((int32_t)r2[l] << 16) | ((int32_t)((uint32_t)r3[l] << 24));
              }
              dst[l * LANE + lane] = w;
            }
          } else {  // partial/empty quad at the batch tail
            for (int64_t l = l0; l < l1; ++l) {
              uint32_t w = 0;
              if (l < L) {
                for (int s = 0; s < 4; ++s) {
                  if (g + s < B) w |= (uint32_t)chars[(g + s) * L + l] << (8 * s);
                }
              }
              dst[l * LANE + lane] = (int32_t)w;
            }
          }
        }
      }
    }
  }
}

int h2r_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
