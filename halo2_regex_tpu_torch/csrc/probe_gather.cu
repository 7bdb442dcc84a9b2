// lane_gather -- the lane-gather probes of tools/ as one H100 kernel:
// probe_tpu.py's k3 (pallas_call at :98), k4 (:118) and k5 (:142),
// probe_tpu2.py's E (k3, :208), and probe_tpu3.py's k1 and gather loop k3
// (vmem_call, :47).
//
// Gather mode: o[r, j] = g[r, f[r, j]] over rows of 128 int32 lanes,
// repeated `steps` times with f taken from the last output (steps 1 for
// k3, k4 and k1; 1024 for E and the gather loop, a chain of dependent
// gathers from on-chip memory and nothing else).  Rows mode (k5):
// o[i, :] = t[c[i], :].
//
// The TPU permutes lanes inside a vector register; the H100 has two
// counterparts, one template form each:
//   SHARED: the row in shared memory, one LDS an output (the form the
//           table scan uses);
//   REGS:   the row in registers, 4 values a lane (lanes j, j + 32, j + 64,
//           j + 96), gathered by four __shfl_sync and a select by the
//           index's top bits.
// Geometry: a block of one warp a row, each thread owning the 4 lanes it
// holds, so a step is 4 independent chains a thread; at [1, 128] that is
// the lone chain on one warp of one SM.  What bounds it: the latency of
// the dependent load (SHARED) or of the shuffles and select (REGS), not
// bytes or operations.  The rows mode reads each row straight from device
// memory, one coalesced 512-byte read a warp.
//
// That serial chain is kept (forms 0 and 1: the lone chain's cycles a
// step are what chip_smoke [11] reads).  The pow forms (3: SHARED, 4:
// REGS) compute the same output by binary exponentiation: with steps > 1
// each row g is a map of [0, 128) into itself, and steps gathers from f
// are g^steps(f).  From p = g and acc = f, for each bit of steps from the
// lowest: where it is set, acc = p[acc]; while a higher bit remains, p =
// p[p] (a lane computes its 4 entries of p o p into registers, the warp
// syncs, then stores them).  1024 steps are 10 squarings and one
// application: 11 dependent rounds, not 1024.  steps = 1 is one gather and
// squares nothing, so g's values need not be indices there.  Each row is
// one warp, kPowRows rows a block.  What bounds it: the launch, then its
// bytes (a row of g and of f read once, a row of o written once).
//
// Preconditions (checked by the plain version, not here): f in [0, 128);
// with steps > 1 also g in [0, 128); c in [0, RT).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;
constexpr int VPT = LANES / 32;  // lanes a thread: t + 32 k

enum Form { SHARED = 0, REGS = 1, ROWS = 2, POW_SHARED = 3, POW_REGS = 4 };

constexpr int kPowRows = 1;  // the pow forms' rows (warps) a block

template <int FORM>
__global__ void __launch_bounds__(32)
gather_kernel(const int32_t* __restrict__ g, const int32_t* __restrict__ f,
              int32_t* __restrict__ o, int steps) {
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* gr = g + (size_t)r * LANES;
  int acc[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) acc[k] = f[(size_t)r * LANES + t + 32 * k];
  if constexpr (FORM == SHARED) {
    __shared__ int32_t row[LANES];
#pragma unroll
    for (int k = 0; k < VPT; ++k) row[t + 32 * k] = gr[t + 32 * k];
    __syncwarp();
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) acc[k] = row[acc[k]];
    }
  } else {
    int v[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) v[k] = gr[t + 32 * k];
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int a = acc[k], src = a & 31, hi = a >> 5;
        const int w0 = __shfl_sync(0xffffffffu, v[0], src);
        const int w1 = __shfl_sync(0xffffffffu, v[1], src);
        const int w2 = __shfl_sync(0xffffffffu, v[2], src);
        const int w3 = __shfl_sync(0xffffffffu, v[3], src);
        acc[k] = hi == 0 ? w0 : hi == 1 ? w1 : hi == 2 ? w2 : w3;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) o[(size_t)r * LANES + t + 32 * k] = acc[k];
}

// lane t's pick of p[a] where p sits in registers as in the REGS form (p[t
// + 32 k] in v[k]): four shuffles and a select by a's top bits
__device__ __forceinline__ int pick_regs(const int (&v)[VPT], int a) {
  const int src = a & 31, hi = a >> 5;
  const int w0 = __shfl_sync(0xffffffffu, v[0], src);
  const int w1 = __shfl_sync(0xffffffffu, v[1], src);
  const int w2 = __shfl_sync(0xffffffffu, v[2], src);
  const int w3 = __shfl_sync(0xffffffffu, v[3], src);
  return hi == 0 ? w0 : hi == 1 ? w1 : hi == 2 ? w2 : w3;
}

template <int FORM>
__global__ void __launch_bounds__(32 * kPowRows)
gather_pow_kernel(const int32_t* __restrict__ g, const int32_t* __restrict__ f,
                  int32_t* __restrict__ o, int R, int steps) {
  const int wr = threadIdx.x / 32, t = threadIdx.x % 32;
  const int r = blockIdx.x * kPowRows + wr;
  if (r >= R) return;  // a whole warp: the syncs below are the warp's own
  int acc[VPT], p[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    acc[k] = f[(size_t)r * LANES + t + 32 * k];
    p[k] = g[(size_t)r * LANES + t + 32 * k];
  }
  if constexpr (FORM == POW_SHARED) {
    __shared__ int32_t rows[kPowRows][LANES];
    int32_t* row = rows[wr];
#pragma unroll
    for (int k = 0; k < VPT; ++k) row[t + 32 * k] = p[k];
    __syncwarp();
#pragma unroll 1
    for (unsigned s = (unsigned)steps; s;) {
      if (s & 1u) {
#pragma unroll
        for (int k = 0; k < VPT; ++k) acc[k] = row[acc[k]];
      }
      s >>= 1;
      if (s) {  // p = p o p: every lane reads before any lane writes
#pragma unroll
        for (int k = 0; k < VPT; ++k) p[k] = row[p[k]];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < VPT; ++k) row[t + 32 * k] = p[k];
        __syncwarp();
      }
    }
  } else {
#pragma unroll 1
    for (unsigned s = (unsigned)steps; s;) {
      if (s & 1u) {
#pragma unroll
        for (int k = 0; k < VPT; ++k) acc[k] = pick_regs(p, acc[k]);
      }
      s >>= 1;
      if (s) {
        int q[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) q[k] = pick_regs(p, p[k]);
#pragma unroll
        for (int k = 0; k < VPT; ++k) p[k] = q[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VPT; ++k) o[(size_t)r * LANES + t + 32 * k] = acc[k];
}

__global__ void __launch_bounds__(32)
rows_kernel(const int32_t* __restrict__ t, const int32_t* __restrict__ c,
            int32_t* __restrict__ o) {
  const int i = blockIdx.x;
  const int32_t* src = t + (size_t)c[i] * LANES;
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    o[(size_t)i * LANES + threadIdx.x + 32 * k] = src[threadIdx.x + 32 * k];
}

}  // namespace

// form 0 SHARED, 1 REGS (the serial chain), 3 POW_SHARED, 4 POW_REGS (by
// squaring): g, f, o [R, 128]; form 2 ROWS: g = t [RT, 128], f = c [R], o
// [R, 128] (steps unused)
extern "C" int h2r_lane_gather(const void* g, const void* f, void* o, int R, int steps,
                               int form, void* stream) {
  if (R <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* gi = (const int32_t*)g;
  const int32_t* fi = (const int32_t*)f;
  int32_t* oi = (int32_t*)o;
  switch (form) {
    case SHARED: gather_kernel<SHARED><<<R, 32, 0, st>>>(gi, fi, oi, steps); break;
    case REGS: gather_kernel<REGS><<<R, 32, 0, st>>>(gi, fi, oi, steps); break;
    case ROWS: rows_kernel<<<R, 32, 0, st>>>(gi, fi, oi); break;
    case POW_SHARED:
      gather_pow_kernel<POW_SHARED>
          <<<(R + kPowRows - 1) / kPowRows, 32 * kPowRows, 0, st>>>(gi, fi, oi, R, steps);
      break;
    case POW_REGS:
      gather_pow_kernel<POW_REGS>
          <<<(R + kPowRows - 1) / kPowRows, 32 * kPowRows, 0, st>>>(gi, fi, oi, R, steps);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
