// table_scan -- the serial table-driven DFA scan of the split matcher.
//
// Replaces the TPU kernels PallasMatcher._scan_kernel (B8,
// halo2_regex_tpu/ops/pallas_scan.py:756, pallas_call at :968) and
// _scan_kernel_seg (B11, :1039, pallas_call at :1195): per def d and string
// b, s = next[d][cls[d][c], s] for each byte c of the window [p0, p0 + LS),
// from the carried-in state init[d, b].  On the TPU the step is a one-hot
// MXU row select of a bf16 class table (with stride-2 pair tables, and
// lo/hi byte planes beyond 256 states), because Mosaic has no fast gather.
// Here the step is a gather.
//
// What bounds it on the H100: the chain of dependent shared-memory loads,
// one per byte (about 30 cycles each), not bytes or operations.  Each
// string's LS steps are serial, so a launch takes at least LS load
// latencies however many strings run beside it; with few strings (64 in
// the 1K-state stress model) the card is nearly idle.  What the design
// does about it: everything else is kept off the chain.  The byte -> class
// map does not depend on the state, so the row offsets of 16 bytes are
// computed from one 16-byte load before their 16 dependent steps, and
// that load is issued 64 bytes ahead of its use; the
// next-state table sits in shared memory as uint16 (96 classes x 1008
// states = 189 KiB for the stress model, under the 227 KiB opt-in), so a
// step is one shared load and an add; states are stored time-major, so a
// warp's 32 stores at one position are one 128-byte line.  A table too
// large for shared memory (or more than 65536 states) is read from global
// memory through the read-only cache instead (smem_bytes = 0).
//
// Layouts (int32 unless stated): chars [B, L] uint8; cmap [n_defs, 256];
// next [n_defs, K, S]; init [n_defs, B] with row stride init_ds; states
// [n_defs, L, B], rows p0..p0 + LS - 1 written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 8;  // table loads in flight per thread while staging
constexpr int kAhead = 4;  // 16-byte char loads in flight ahead of the chain

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
table_scan_kernel(const uint8_t* __restrict__ chars, const int32_t* __restrict__ cmap,
                  const int32_t* __restrict__ next, const int32_t* __restrict__ init,
                  long long init_ds, int32_t* __restrict__ states, int B, int L, int K,
                  int S, int p0, int LS, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  __shared__ int row_off[256];  // class(c) * S: the table row of byte c
  const int d = blockIdx.y;
  const int32_t* nx = next + (size_t)d * K * S;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) row_off[i] = cmap[d * 256 + i] * S;
  if (kSmem) {
    // kStage independent 16-byte loads in flight per thread: the table
    // (387 KiB of int32 for the stress model) arrives in a few round trips
    const int n = K * S;
    const int n4 = (n & 3) == 0 && ((uintptr_t)nx & 15) == 0 ? n / 4 : 0;
    const int4* nx4 = reinterpret_cast<const int4*>(nx);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kStage * blockDim.x) {
      int4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = __ldg(nx4 + (i < n4 ? i : 0));
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < n4) {
          tab[4 * i] = (uint16_t)v[u].x;
          tab[4 * i + 1] = (uint16_t)v[u].y;
          tab[4 * i + 2] = (uint16_t)v[u].z;
          tab[4 * i + 3] = (uint16_t)v[u].w;
        }
      }
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) tab[i] = (uint16_t)__ldg(nx + i);
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  int s = init[(size_t)d * init_ds + b];
  const uint8_t* row = chars + (size_t)b * L + p0;
  int32_t* out = states + ((size_t)d * L + p0) * B + b;
  int p = 0;
  if (vec) {
    // 16 bytes a load, kAhead loads ahead of the chain, so no load's
    // latency lands on it
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    const int n16 = LS / 16;
    uint4 q[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) q[a] = __ldg(row4 + (a < n16 ? a : 0));
    for (int i = 0; i < n16; i += kAhead) {
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        if (i + a < n16) {
          const uint4 v = q[a];
          if (i + a + kAhead < n16) q[a] = __ldg(row4 + i + a + kAhead);
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          int off[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) off[j] = row_off[(w[j >> 2] >> (8 * (j & 3))) & 0xFF];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if constexpr (kSmem) {
              s = tab[off[j] + s];
            } else {
              s = __ldg(nx + off[j] + s);
            }
            out[(size_t)(16 * (i + a) + j) * B] = s;
          }
        }
      }
    }
    p = 16 * n16;
  }
  for (; p < LS; ++p) {
    const int o = row_off[row[p]];
    if constexpr (kSmem) {
      s = tab[o + s];
    } else {
      s = __ldg(nx + o + s);
    }
    out[(size_t)p * B] = s;
  }
}

}  // namespace

// The card's per-block shared-memory opt-in limit, for the wrapper's choice
// of smem_bytes.
extern "C" int h2r_smem_optin(void) {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

extern "C" int h2r_table_scan(const void* chars, const void* cmap, const void* next,
                              const void* init, long long init_ds, void* states, int n_defs,
                              int B, int L, int K, int S, int p0, int LS, int vec,
                              int smem_bytes, void* stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, n_defs);
  if (smem_bytes > 0) {
    if (smem_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          table_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    table_scan_kernel<true><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
        (const uint8_t*)chars, (const int32_t*)cmap, (const int32_t*)next,
        (const int32_t*)init, init_ds, (int32_t*)states, B, L, K, S, p0, LS, vec);
  } else {
    table_scan_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chars, (const int32_t*)cmap, (const int32_t*)next,
        (const int32_t*)init, init_ds, (int32_t*)states, B, L, K, S, p0, LS, vec);
  }
  return (int)cudaGetLastError();
}
