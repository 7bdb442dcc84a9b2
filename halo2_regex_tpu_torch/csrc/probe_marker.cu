// marker_match -- the marker-stream verdict of tools/probe_tpu57_lib.py
// (marker_match_reduced :133) as an H100 kernel: does each string end in a
// line "from:" NAME+ "@" DOM+ "\r\n" at its start or after a "\r\n", with
// no DFA and no serial state beyond a few words a string.
//
// Replaces the TPU kernels made by make_marker_kernel (tools/probe_tpu57.py
// :190, pallas_call at :198; tools/probe_tpu61.py :228, pallas_call at
// :237).  Each held a block's whole [10, L, 256] stack (10 MiB) in VMEM and
// ran the program position-parallel: log2 L rounds of two affine scans and
// a tree OR.  No H100 block holds that (227 KiB of shared memory), so this
// kernel walks the positions left to right instead.  Per word (32 strings)
// and position i the program is (c = the class words ANDed with enable):
//
//   ls[i]   = (i == 0 ? ~0 : 0) | cr[i-2] & lf[i-1]
//   k0 = ls & f, k1 = k0' & r, ..., k4 = k3' & colon   (' = at i - 1)
//   ns[i]   = name[i] & (ns[i-1] | k4[i-1])            NAME+ after "from:"
//   v[i]    = dom[i] & v[i-1] | at[i] & ns[i-1]        v = ds | at_ok
//   ds[i]   = dom[i] & v[i-1]                          DOM+ after "@"
//   done[i] = ds[i-2] & cr[i-1] & lf[i] & end[i]       "\r\n" at the end
//
// and the verdict is the OR of done over i: the lib's program with its
// at_ok, ds and tail folded into v (tests/test_torch_probes_t2c.py holds
// the torch twins of both forms to the TPU body bit for bit).
//
// Layouts: stack [10, L, NW] int32 (planes 0-7 the byte bits, 8 the
// enable plane, 9 the end plane); out [NW] int32.  Lane = word in both
// forms, so a warp's loads of one position are 32 neighbouring words: one
// 128-byte line a plane.
//
// What bounds it: bytes.  The stack is read once (41.9 MB at B=32768 x
// L=1024: 0.0125 ms at 3.35 TB/s); the program is 100 int32 ops a word
// and position (76 of them the class program, probe_marker_class.cuh),
// 0.0070 ms at the card's int32 rate.  Two forms:
//
// serial (chunk = 0): a thread a word walks all of L, the 10 words of the
//   next RING - 1 positions in flight to a shared-memory ring by cp.async
//   (probe_ring.cuh, K2's design), blocks of 32: K2's geometry (1024
//   threads at B=32768), so it is bound by one thread's dependent walk.
// chunked (chunk = C): a warp a (word group of 32 words, chunk of C
//   positions), a lane a word.  A warp walks its chunk's HALO positions
//   first (the cascade and the line start reach back 7), then its C
//   positions, then AHEAD positions past it (its ds at e-1 and e feed
//   done at e+1 and e+2).  ns and v at the chunk's start are unknown, but
//   every register is AND/OR-linear in them with no term holding both, so
//   the walk carries each of ns, v, ds and done as a constant and a
//   coefficient of each carry-in (the serial form's walk with both
//   carry-ins zero is its constant part: the compiler drops the
//   coefficients there).  The chunk's summary is ns and v at its end and
//   its OR of done, as masks.
//   Geometry (geometry() below): a word group's nch = L / C chunks are
//   split over a cluster of K blocks (the largest divisor of nch up to
//   kMaxCluster: 16 at L = 1024, past the portable 8), each block NB =
//   nch / K consecutive chunks, walked W warps at a time (W x C <= kSpan
//   positions a round).  A round's window, its W x C positions and a
//   piece of kPiece before and after them, is staged whole in shared
//   memory by TMA boxes [10 planes, kPiece positions, 32 words] (a 3-D
//   tensor map over the stack; positions past L read as zeros, those
//   before 0 are written as zeros), each box on its own mbarrier and
//   issued in the order the warps reach them, so a warp starts when its
//   first box lands and the halo and ahead positions of the block's inner
//   chunks come from the tile, read once.  Composition: warp 0 folds the
//   round's chunk summaries into the block's in order; then every rank
//   writes its block summary into rank 0's shared memory (distributed
//   shared memory, after a cluster barrier: rank 0's tile is free), and
//   after a second barrier rank 0 folds the K summaries in order and
//   writes each of its 32 verdicts once.  One pass over the stack, one
//   launch, no zero fill; the halo costs HALO + AHEAD extra class
//   programs a chunk (56 % at C = 16) and the pieces 2 kPiece extra
//   positions a round read (25 % at kSpan = 64, from L2: a neighbour
//   block reads them too).  On the H100 the boxes' loads bound it: the
//   kernel without its walk takes as long (kernel_ab.py's no_compute), and
//   16-byte cp.async copies of the same boxes are slower.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "probe_marker_class.cuh"
#include "probe_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPlanes = 10;
constexpr int HALO = 7;
constexpr int AHEAD = 2;
constexpr int kSerialThreads = 32;
constexpr int RING = 16;  // positions in the serial form's ring (RING - 1 in flight): 20 KiB
constexpr int kWords = 32;       // a chunked warp's words: a 128-byte line a plane and position
constexpr int kPiece = 8;        // positions a TMA box
constexpr int kSpan = 64;        // positions a chunked block's round walks at most (W x C)
constexpr int kMaxCluster = 16;  // blocks over L (past the portable 8: opted in)
constexpr int kMaxPieces = kSpan / kPiece + 2;         // a round's window: a piece each side
constexpr int kPieceBytes = kPlanes * kPiece * kWords * 4;  // 10 KiB, laid out [10][8][32]
constexpr int kTileBytes = kMaxPieces * kPieceBytes;

enum Phase { kHalo, kMain, kAhead };

// A word's registers at position i.  Where a chunk starts, ns[s-1] and
// v[s-1] are unknown: ns = ns0 | nsN & ns[s-1], v = v0 | vN & ns[s-1] |
// vV & v[s-1], and the same split for ds and the OR of done.
struct Walk {
  uint32_t cr1 = 0, cr2 = 0, lf1 = 0;           // cr at i-1, i-2; lf at i-1
  uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0, k4 = 0;  // the from: cascade at i-1
  uint32_t ns0 = 0, nsN = ~0u;
  uint32_t v0 = 0, vN = 0, vV = ~0u;
  uint32_t d0a = 0, dNa = 0, dVa = 0;  // ds at i-1
  uint32_t d0b = 0, dNb = 0, dVb = 0;  // ds at i-2
  uint32_t o0 = 0, oN = 0, oV = 0;     // the OR of done
};

// One position: kHalo the cascade alone, kMain everything, kAhead the done
// terms of ds the chunk owns (ds past the chunk is the next chunk's: zero).
template <int PHASE>
__device__ __forceinline__ void step(Walk& s, const uint32_t* p, bool first) {
  MarkerClasses c;
  marker_classes(p, c);
  const uint32_t en = p[8];
  const uint32_t f = c.f & en, r = c.r & en, o = c.o & en, m = c.m & en;
  const uint32_t colon = c.colon & en, at = c.at & en, cr = c.cr & en, lf = c.lf & en;
  const uint32_t name = c.name & en, dom = c.dom & en;
  if (PHASE != kHalo) {
    const uint32_t t = s.cr1 & lf & p[9];
    s.o0 |= s.d0b & t;
    s.oN |= s.dNb & t;
    s.oV |= s.dVb & t;
  }
  if (PHASE == kMain) {
    const uint32_t n0 = dom & s.v0, nN = dom & s.vN, nV = dom & s.vV;
    s.v0 = n0 | (at & s.ns0);
    s.vN = nN | (at & s.nsN);
    s.vV = nV;
    s.ns0 = name & (s.ns0 | s.k4);
    s.nsN = name & s.nsN;
    s.d0b = s.d0a, s.dNb = s.dNa, s.dVb = s.dVa;
    s.d0a = n0, s.dNa = nN, s.dVa = nV;
  } else if (PHASE == kAhead) {
    s.d0b = s.d0a, s.dNb = s.dNa, s.dVb = s.dVa;
    s.d0a = s.dNa = s.dVa = 0;
  }
  const uint32_t ls = (first ? ~0u : 0u) | (s.cr2 & s.lf1);
  s.k4 = s.k3 & colon;
  s.k3 = s.k2 & m;
  s.k2 = s.k1 & o;
  s.k1 = s.k0 & r;
  s.k0 = ls & f;
  s.cr2 = s.cr1;
  s.cr1 = cr;
  s.lf1 = lf;
}

// The summary of chunk a then chunk b (probe_tpu57_lib.compose), each in
// SUMMARY's order: na nb vv vn v0 o0 on ov.
__device__ __forceinline__ void compose(uint32_t (&a)[8], const uint32_t (&b)[8]) {
  const uint32_t na = a[0], nb = a[1], vv = a[2], vn = a[3], v0 = a[4];
  a[0] = b[0] & na;
  a[1] = (b[0] & nb) | b[1];
  a[2] = b[2] & vv;
  a[3] = (b[2] & vn) | (b[3] & na);
  a[4] = (b[2] & v0) | (b[3] & nb) | b[4];
  a[5] = a[5] | b[5] | (b[6] & nb) | (b[7] & v0);
  a[6] = a[6] | (b[6] & na) | (b[7] & vn);
  a[7] = a[7] | (b[7] & vv);
}

// The chunked form's split of a word group's L (chunk C): K blocks a
// cluster, NB chunks a block, W warps a block (NB / W rounds).
__host__ __device__ inline void geometry(int L, int C, int& K, int& NB, int& W) {
  const int nch = L / C;
  K = 1;
  for (int k = nch < kMaxCluster ? nch : kMaxCluster; k > 1; --k)
    if (nch % k == 0) { K = k; break; }
  NB = nch / K;
  W = 1;
  for (int w = NB < kSpan / C ? NB : kSpan / C; w > 1; --w)
    if (NB % w == 0) { W = w; break; }
}

template <int C>
__global__ void __launch_bounds__(kSpan / 8 * 32)
marker_chunked_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out, int L,
                      int NB, int W) {
  extern __shared__ __align__(128) unsigned char tile[];  // kMaxPieces x [10][kPiece][32] words
  __shared__ __align__(8) uint64_t bar[kMaxPieces];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x, wg = blockIdx.y;  // the cluster spans gridDim.x
  const int n_pieces = W * C / kPiece + 2;
  if (threadIdx.x == 0) {
    for (int q = 0; q < n_pieces; ++q) hopper::mbar_init(&bar[q], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  uint32_t run[8] = {~0u, 0, ~0u, 0, 0, 0, 0, 0};  // warp 0: the block's summary (the identity)
  for (int rd = 0; rd < NB / W; ++rd) {
    const int s0 = (rank * NB + rd * W) * C;  // the round's first position; its window from s0 - kPiece
    // box q holds window positions [q kPiece, (q + 1) kPiece); one wholly
    // outside [0, L) is written as zeros (the walk over zeros before 0 is
    // a fresh start; past L it adds nothing) and its barrier arrived on
    auto outside = [&](int q) {
      const int g = s0 - kPiece + q * kPiece;
      return g + kPiece <= 0 || g >= L;
    };
    if (threadIdx.x == 0) {
      hopper::fence_proxy_async();  // the tile's generic accesses (last round) before TMA's writes
      // the warps' first boxes first, then their second, ...
      for (int j = 0; j < C / kPiece + 2; ++j)
        for (int v = 0; v < W; ++v) {
          const int q = v * C / kPiece + j;
          if (j >= C / kPiece && v < W - 1) continue;  // warp v + 1's box
          if (outside(q)) {
            hopper::mbar_arrive(&bar[q]);
          } else {
            hopper::mbar_expect_tx(&bar[q], kPieceBytes);
            hopper::tma_load_3d(tile + q * kPieceBytes, &map, wg * kWords,
                                s0 - kPiece + q * kPiece, 0, &bar[q]);
          }
        }
    }
    if (outside(0) || outside(n_pieces - 1)) {
      for (int q = 0; q < n_pieces; ++q)
        if (outside(q))
          for (int i = threadIdx.x; i < kPieceBytes / 16; i += blockDim.x)
            ((uint4*)(tile + q * kPieceBytes))[i] = make_uint4(0, 0, 0, 0);
      __syncthreads();
    }
    Walk s;
    int have = -1;  // the last box this warp waited for
    uint32_t p[kPlanes];
    auto load = [&](int x) {  // window position x into p
      const int q = x / kPiece;
      if (q != have) {
        hopper::mbar_wait(&bar[q], rd & 1);
        have = q;
      }
      const uint32_t* b = (const uint32_t*)(tile + q * kPieceBytes) + (x % kPiece) * kWords + lane;
#pragma unroll
      for (int j = 0; j < kPlanes; ++j) p[j] = b[j * kPiece * kWords];
    };
    const int x0 = kPiece + warp * C;  // the chunk's first position in the window
#pragma unroll 1
    for (int x = x0 - HALO; x < x0; ++x) {
      load(x);
      step<kHalo>(s, p, false);
    }
#pragma unroll 4
    for (int x = x0; x < x0 + C; ++x) {
      load(x);
      step<kMain>(s, p, s0 - kPiece + x == 0);
    }
#pragma unroll 1
    for (int x = x0 + C; x < x0 + C + AHEAD; ++x) {
      load(x);
      step<kAhead>(s, p, false);
    }
    __syncthreads();  // every warp is done with the tile: it holds the summaries now
    uint32_t* sums = (uint32_t*)tile;  // [W][8][32]
    const uint32_t mine[8] = {s.nsN, s.ns0, s.vV, s.vN, s.v0, s.o0, s.oN, s.oV};
#pragma unroll
    for (int f = 0; f < 8; ++f) sums[(warp * 8 + f) * kWords + lane] = mine[f];
    __syncthreads();
    if (warp == 0) {
      for (int v = 0; v < W; ++v) {
        uint32_t b[8];
#pragma unroll
        for (int f = 0; f < 8; ++f) b[f] = sums[(v * 8 + f) * kWords + lane];
        compose(run, b);
      }
      __syncwarp();  // read before thread 0 issues the next round's boxes
    }
  }
  // every rank's block summary into rank 0's tile, in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank is done with its tile (rank 0's takes the summaries)
  uint32_t* parts = cluster.map_shared_rank((uint32_t*)tile, 0);  // [K][8][32]
  if (warp == 0) {
#pragma unroll
    for (int f = 0; f < 8; ++f) parts[(rank * 8 + f) * kWords + lane] = run[f];
  }
  cluster.sync();  // every summary is in
  if (rank == 0 && warp == 0) {
    const uint32_t* mine = (const uint32_t*)tile;
    uint32_t acc[8];
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[f] = mine[f * kWords + lane];
    for (int r = 1; r < (int)gridDim.x; ++r) {
      uint32_t b[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) b[f] = mine[(r * 8 + f) * kWords + lane];
      compose(acc, b);
    }
    out[wg * kWords + lane] = (int32_t)acc[5];  // the OR of done with both carry-ins zero
  }
}

__global__ void __launch_bounds__(kSerialThreads)
marker_serial_kernel(const int32_t* __restrict__ st, int32_t* __restrict__ out, int NW, int L) {
  __shared__ uint32_t ring[RING][kPlanes][kSerialThreads];  // position p in slot p % RING
  const int t = threadIdx.x, w = blockIdx.x * kSerialThreads + t;
  const size_t plane = (size_t)L * NW;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < L) {
#pragma unroll
      for (int j = 0; j < kPlanes; ++j)
        probe_ring::copy4(&ring[p % RING][j][t], st + j * plane + (size_t)p * NW + w);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  Walk s;
#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    fetch(i + RING - 1);  // into slot (i - 1) % RING, read at i - 1
    probe_ring::wait_oldest<RING>();
    uint32_t p[kPlanes];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) p[j] = ring[i % RING][j][t];
    step<kMain>(s, p, i == 0);
  }
  out[w] = (int32_t)s.o0;
  probe_ring::wait_all();
}

// the map of the stack [10, L, NW] int32 in boxes [10, kPiece, 32] (no
// swizzle: a box lands as [10][kPiece][32] words); false where refused
inline bool stack_map(CUtensorMap* m, const void* st, int NW, int L) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)NW, (cuuint64_t)L, kPlanes};
  const cuuint64_t strides[2] = {(cuuint64_t)NW * 4, (cuuint64_t)NW * L * 4};
  const cuuint32_t box[3] = {kWords, kPiece, kPlanes};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(st), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
int launch_chunked(const void* st, void* out, int NW, int L, cudaStream_t stream) {
  int K, NB, W;
  geometry(L, C, K, NB, W);
  CUtensorMap map;
  if (!stack_map(&map, st, NW, L)) return (int)cudaErrorInvalidValue;
  auto kernel = marker_chunked_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kTileBytes);
  if (e == cudaSuccess && K > 8)  // past the portable cluster size
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, NW / kWords);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = (W * C / kPiece + 2) * kPieceBytes;  // a round's window
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map, (int32_t*)out, L, NB, W);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// chunk 0: the serial form; else the chunked form (its geometry: geometry())
extern "C" int h2r_marker_match(const void* stack, void* out, int NW, int L, int chunk,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (NW <= 0 || NW % kSerialThreads || L <= 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) {
    marker_serial_kernel<<<NW / kSerialThreads, kSerialThreads, 0, s>>>(
        (const int32_t*)stack, (int32_t*)out, NW, L);
    return (int)cudaGetLastError();
  }
  if (chunk < 0 || L % chunk || (uintptr_t)stack % 16) return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 8: return launch_chunked<8>(stack, out, NW, L, s);
    case 16: return launch_chunked<16>(stack, out, NW, L, s);
    case 32: return launch_chunked<32>(stack, out, NW, L, s);
    case 64: return launch_chunked<64>(stack, out, NW, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
