// fb_only -- final-state boundary planes for match-only serving.
//
// Replaces the TPU kernel BitplaneMatcher._make_fb_only
// (halo2_regex_tpu/ops/bitplane.py:1606, pallas_call at :1635).
//
// Computes, per word and def, fb[d, j] = OR over positions l of
// (bnd[l] & log[d, j][l]), with bnd[l] = en[l] & ~en[l + 1] (en[L] = 0),
// i.e. the log bits of each string's state after its last enabled byte,
// ORed with the first state's bits for empty strings (~en[0]).  bnd needs
// only the neighbouring row, so nothing is serial: it is a pure OR
// reduction over positions.
//
// What bounds it on the H100: device-memory bytes, and the latency of two
// dependent reads.  It reads the enable plane (4 MiB at B=32768 x
// L=1024) and, where a bnd word is nonzero, that position's log words:
// each string has one boundary row, so a word's 32 strings touch at most
// 32 of its L rows, and the log reads are the 32-byte sectors of those
// rows, not the SB_SUM planes.
//
// Design: a block owns 8 words (one 32-byte sector of a row) and a cluster
// of CS = min(8, ceil(L / 128)) blocks owns all of L for them, so the
// grid is NW / 8 x CS blocks (128 at B=4096 x L=1024, 1024 at B=32768)
// and every output word has one writer: no zero fill, no atomics.  Thread
// (word wl, group pg) = (tid % 8, tid / 8) of block rank r reads the
// enable words of PER = 4 consecutive positions (and the next one) at
// r * 128 + 4 pg, then r + CS steps of 128 on: a warp's loads are four
// whole sectors.  Every enable load is issued before any is used, then
// every log load its bnd words ask for (predicated loads, not branches, so
// all are in flight at once).  The partial ORs meet by two shuffle rounds
// (the warp's four groups of each word), shared memory (the block's eight
// warps), and the cluster's distributed shared memory: each rank stores
// its partials into rank 0's, one cluster barrier, and rank 0 ORs them,
// adds the empty-string term (~en[0], which its threads of position 0
// loaded) through the generated h2r_fb (which also maps log planes to the
// [NDEFS, 8] slots) and stores the output words.
//
// Layouts: logs [NWS, SB_SUM, L, 128]; en [NWS, L, 128]; fb [NWS, NDEFS,
// 8, 128]; all int32.

#include <cooperative_groups.h>

#include "bitplane_common.cuh"
#include "h2r_circuits.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 8;                    // words a block: one 32-byte sector
constexpr int kThreads = 256;                // 8 words x 32 position groups
constexpr int kGroups = kThreads / kWords;   // position groups a block
constexpr int kPer = 4;                      // consecutive positions a thread
constexpr int kStep = kGroups * kPer;        // positions a block step
constexpr int kMaxCluster = 8;               // the portable cluster size

// *p where pred != 0, else 0: a predicated load, not a branch, so that a
// thread's log loads are all in flight at once
__device__ __forceinline__ uint32_t load_if(const int32_t* p, uint32_t pred) {
  uint32_t v = 0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q ld.global.nc.u32 %0, [%1];\n}\n"
      : "+r"(v)
      : "l"(p), "r"(pred));
  return v;
}

__global__ void __launch_bounds__(kThreads)
fb_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ en,
          int32_t* __restrict__ fb, int L) {
  __shared__ uint32_t warp_part[kThreads / 32][H2R_SB_SUM][kWords];
  __shared__ uint32_t parts[kMaxCluster][H2R_SB_SUM][kWords];  // rank 0's: every rank's
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int w0 = (blockIdx.x / cs) * kWords;
  const int nws = w0 / H2R_LANE, lane0 = w0 % H2R_LANE;
  const int tid = threadIdx.x, wl = tid % kWords, pg = tid / kWords;
  const size_t plane = (size_t)L * H2R_LANE;
  const int32_t* en_w = en + nws * plane + lane0 + wl;
  const int32_t* lg_w = logs + nws * H2R_SB_SUM * plane + lane0 + wl;

  uint32_t acc[H2R_SB_SUM];
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] = 0;
  uint32_t en0 = 0;  // position 0's enable word (thread wl of rank 0)
  for (int l0 = rank * kStep + pg * kPer; l0 < L; l0 += cs * kStep) {
    uint32_t e[kPer + 1];
#pragma unroll
    for (int p = 0; p <= kPer; ++p)
      e[p] = load_if(en_w + (size_t)(l0 + p) * H2R_LANE, l0 + p < L);
    if (l0 == 0) en0 = e[0];
    uint32_t bnd[kPer], lg[kPer][H2R_SB_SUM];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      bnd[p] = e[p] & ~e[p + 1];
#pragma unroll
      for (int j = 0; j < H2R_SB_SUM; ++j)
        lg[p][j] = load_if(lg_w + j * plane + (size_t)(l0 + p) * H2R_LANE, bnd[p]);
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
#pragma unroll
      for (int j = 0; j < H2R_SB_SUM; ++j) acc[j] |= bnd[p] & lg[p][j];
    }
  }
  // lanes r, r ^ 8, r ^ 16, r ^ 24 hold the same word
#pragma unroll
  for (int j = 0; j < H2R_SB_SUM; ++j) {
    acc[j] |= __shfl_xor_sync(0xFFFFFFFFu, acc[j], 8);
    acc[j] |= __shfl_xor_sync(0xFFFFFFFFu, acc[j], 16);
  }
  if (tid % 32 < kWords) {
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) warp_part[tid / 32][j][wl] = acc[j];
  }
  __syncthreads();
  if (tid < kWords * H2R_SB_SUM) {  // the block's partial, stored into rank 0's memory
    const int j = tid / kWords, w = tid % kWords;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) v |= warp_part[k][j][w];
    cluster.map_shared_rank(&parts[0][0][0], 0)[(rank * H2R_SB_SUM + j) * kWords + w] = v;
  }
  cluster.sync();  // every rank's partial is in rank 0's memory
  if (rank == 0 && tid < kWords) {
    uint32_t all[H2R_SB_SUM];
#pragma unroll
    for (int j = 0; j < H2R_SB_SUM; ++j) all[j] = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
#pragma unroll
        for (int j = 0; j < H2R_SB_SUM; ++j) all[j] |= parts[r][j][tid];
      }
    }
    // strings whose first byte is disabled are empty: their final state is
    // the first state
    uint32_t out[H2R_NDEFS * 8];
    h2r_fb(all, ~en0, out);
#pragma unroll
    for (int k = 0; k < H2R_NDEFS * 8; ++k)
      fb[((size_t)nws * H2R_NDEFS * 8 + k) * H2R_LANE + lane0 + tid] = (int32_t)out[k];
  }
}

}  // namespace

extern "C" int h2r_fb_only(const void* logs, const void* en, void* fb, int NWS, int L,
                           void* stream) {
  const int groups = NWS * H2R_LANE / kWords;
  if (groups == 0 || L == 0) return 0;
  const int cs = min(kMaxCluster, (L + kStep - 1) / kStep);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fb_kernel, (const int32_t*)logs,
                                             (const int32_t*)en, (int32_t*)fb, L);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
