// loop_floor and slab_scan -- the serial-loop probes of tools/probe_tpu9.py
// as H100 kernels.
//
// loop_floor replaces the TPU kernels ka (A, tools/probe_tpu9.py:53,
// pallas_call at :62) and kb (B, :79, pallas_call at :92): o[i] = x[i] +
// o[i - 1] down the rows of x [L, TB] int32, one row a loop step (SLAB =
// 1) or eight (SLAB = 8: the eight rows are read before the eight adds).
// The sums wrap as JAX's int32 adds do (uint32_t here: signed overflow is
// undefined in C++).  Two forms:
//
// Chunked (floor_chunk_kernel, the default): adds that wrap are
// associative and commutative, so a scan over chunks of rows gives the
// same bits as the loop, and the function needs no serial walk on one SM.
// A block owns a tile of 32 columns x C rows (C = 8 R: each of its eight
// warps R rows, a lane a column, so each row segment is one 128-byte line).
// A lane issues all its R loads before its adds and keeps the values in
// registers; the warps' column sums are scanned in shared memory; a
// decoupled look-back (probe_lookback.cuh) over the column group's earlier
// tiles gives the tile its prefix: each tile publishes its sums at once,
// then its inclusive prefix, one 64-bit word a column (the value, and the
// call's epoch with a flag), and reads back, kWindow tiles a round, until
// it meets an inclusive prefix.  Then each lane adds its prefix and stores
// its rows.  One launch a call, whatever SLAB is (the function is the
// same); its floor is the bytes, one read of x and one write of o.
//
// Serial (loop_floor_kernel<SLAB>, form "serial": what one step of a serial
// loop costs on this card with its rows already in shared memory; chip_smoke
// [10] sets it beside configs[3]'s table-scan chain).  The probes read x
// from VMEM, on-chip memory; here the rows of the next FLOOR_RING - 1
// groups of eight are in flight to a shared-memory ring (probe_ring.cuh),
// so a step waits on the loop itself (a shared-memory read, the add, the
// store, the loop's own count and branch), not on device memory.  One
// thread owns one column and walks its rows in order, blocks of 32 threads
// (a warp an SM while there are fewer warps than SMs); the loop is kept
// rolled (#pragma unroll 1).
//
// slab_scan replaces kc (C, :120, pallas_call at :164): per step, the
// class of the byte c = x[i, b] (the probe's thresholds over classes[],
// which equal classes[c] for c in [0, 256), classes[0] below and
// classes[255] above), then v_j = tk[class, j * S + s] for j = 0..3 and
// s = v_0, from s = 0.  The probe picks the columns with a one-hot bf16
// product and a select: exact for table values in [0, S) (the wrapper's
// precondition), so this gather is the same function.  Its kernels are
// probe_slab.cuh's, chunked or serial, with four outputs from state 0.
//
// Layouts: x [L, TB] int32; o [L, TB] int32; tk [K, 4S] int32; classes
// [256] int32; slab_scan's four outputs [L, TB] int32.  L % 8 == 0 for
// slab_scan and for loop_floor's SLAB = 8.  ``chunk``: 0 for the serial
// form, else the chunked form's C (64, 128 or 512: ops/kernels.py
// `scan_chunk`'s), with the scratch (the ticket, then the status words)
// and the call's epoch.  The wrapper keeps a scratch for each kernel, so
// an address of it holds the same kind of word in every call.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_lookback.cuh"
#include "probe_ring.cuh"
#include "probe_slab.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int SCAN_SLAB = 8;  // rows a group of loop_floor's ring (probe C's SB)
constexpr int FLOOR_RING = 16;  // groups in flight: its steps are short

template <int SLAB>
__global__ void __launch_bounds__(THREADS)
loop_floor_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int L, int TB) {
  __shared__ uint32_t ring[FLOOR_RING][SCAN_SLAB][THREADS];  // group p in slot p % FLOOR_RING
  const int t = threadIdx.x;
  const int b = blockIdx.x * THREADS + t;
  if (b >= TB) return;
  auto fetch = [&](int p) {  // the rows of group p below L; an empty group past L
#pragma unroll
    for (int j = 0; j < SCAN_SLAB; ++j)
      if (p * SCAN_SLAB + j < L)
        probe_ring::copy4(&ring[p % FLOOR_RING][j][t],
                          x + (size_t)(p * SCAN_SLAB + j) * TB + b);
    probe_ring::commit();
  };
  for (int p = 0; p < FLOOR_RING - 1; ++p) fetch(p);
  uint32_t carry = 0;
#pragma unroll 1
  for (int i = 0; i < L; i += SLAB) {
    if (i % SCAN_SLAB == 0) {  // every step of SLAB = 8, every eighth of SLAB = 1
      fetch(i / SCAN_SLAB + FLOOR_RING - 1);  // into the slot that group p - 1 was read from
      probe_ring::wait_oldest<FLOOR_RING>();
    }
    const uint32_t* r = &ring[(i / SCAN_SLAB) % FLOOR_RING][i % SCAN_SLAB][t];
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      carry += r[j * THREADS];
      o[(size_t)(i + j) * TB + b] = (int32_t)carry;
    }
  }
  probe_ring::wait_all();
}

constexpr int kFloorWarps = 8;  // a tile's warps: C = kFloorWarps * R rows
constexpr int kFloorThreads = 32 * kFloorWarps;

template <int R>  // rows a lane
__global__ void __launch_bounds__(kFloorThreads)
floor_chunk_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int L, int TB,
                   uint32_t* ticket, unsigned long long* status, uint32_t epoch) {
  constexpr int C = kFloorWarps * R;
  constexpr int kWin = probe_lookback::kWindow;
  __shared__ uint32_t part[kFloorWarps][32];  // each warp's column sums, then their prefix
  __shared__ uint32_t before[32];  // the tile's prefix a column
  const uint32_t t = probe_lookback::take_ticket(ticket);
  const int n_grp = (TB + 31) / 32;
  const int g = t % n_grp, r = t / n_grp;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = g * 32 + lane;
  const int i0 = r * C + w * R;
  uint32_t v[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = (b < TB && i0 + i < L) ? (uint32_t)x[(size_t)(i0 + i) * TB + b] : 0u;
#pragma unroll
  for (int i = 1; i < R; ++i) v[i] += v[i - 1];
  part[w][lane] = v[R - 1];
  __syncthreads();
  if (w == 0) {
    uint32_t agg = 0;
#pragma unroll
    for (int k = 0; k < kFloorWarps; ++k) {
      const uint32_t p = part[k][lane];
      part[k][lane] = agg;
      agg += p;
    }
    // status word: (epoch << 1 | inclusive) << 32 | value
    unsigned long long* mine = status + (size_t)t * 32 + lane;
    const unsigned long long tag = (unsigned long long)(epoch << 1) << 32, inc = 1ull << 32;
    uint32_t excl = 0;
    if (r == 0) {
      probe_lookback::st_relaxed(mine, tag | inc | agg);
    } else {
      probe_lookback::st_relaxed(mine, tag | agg);  // the tile's sums, at once
      // look back: each round reads the column's words of kWin earlier
      // tiles at once and takes them nearest first, to the first inclusive
      // prefix or the first word not yet written
      int k = (int)t - n_grp;  // the nearest tile this column still needs, -1 when done
      while (__any_sync(0xffffffffu, k >= 0)) {
        if (k >= 0) {
          unsigned long long wd[kWin];
#pragma unroll
          for (int i = 0; i < kWin; ++i)
            wd[i] = k - i * n_grp >= 0
                        ? probe_lookback::ld_relaxed(status + (size_t)(k - i * n_grp) * 32 + lane)
                        : 0ull;
          int used = 0;
          bool stop = false, done = false;
#pragma unroll
          for (int i = 0; i < kWin; ++i) {
            const uint32_t hi = (uint32_t)(wd[i] >> 32);
            const bool take = !stop && (hi >> 1) == epoch;
            if (take) {
              excl += (uint32_t)wd[i];
              used = i + 1;
              done = hi & 1;
            }
            stop = !take || done;
          }
          k = done ? -1 : k - used * n_grp;
        }
      }
      probe_lookback::st_relaxed(mine, tag | inc | (excl + agg));
    }
    before[lane] = excl;
  }
  __syncthreads();
  const uint32_t add = before[lane] + part[w][lane];
  if (b < TB) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i0 + i < L) o[(size_t)(i0 + i) * TB + b] = (int32_t)(v[i] + add);
  }
}

template <int R>
int floor_chunk(const void* x, void* o, int L, int TB, void* scratch, unsigned epoch,
                cudaStream_t st) {
  const int n_blk = (TB + 31) / 32 * ((L + kFloorWarps * R - 1) / (kFloorWarps * R));
  if (n_blk == 0) return (int)cudaSuccess;
  floor_chunk_kernel<R><<<n_blk, kFloorThreads, 0, st>>>(
      (const int32_t*)x, (int32_t*)o, L, TB, (uint32_t*)scratch,
      (unsigned long long*)((char*)scratch + probe_lookback::kTicketBytes), epoch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int h2r_loop_floor(const void* x, void* o, int slab, int L, int TB, int chunk,
                              void* scratch, int epoch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (slab != 1 && (slab != 8 || L % 8)) return (int)cudaErrorInvalidValue;
  if (chunk) {
    if (scratch == nullptr || epoch <= 0 || epoch >= (1 << 30)) return (int)cudaErrorInvalidValue;
    switch (chunk) {
      case 64: return floor_chunk<8>(x, o, L, TB, scratch, (unsigned)epoch, st);
      case 128: return floor_chunk<16>(x, o, L, TB, scratch, (unsigned)epoch, st);
      case 512: return floor_chunk<64>(x, o, L, TB, scratch, (unsigned)epoch, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((TB + THREADS - 1) / THREADS);
  if (slab == 1)
    loop_floor_kernel<1><<<grid, THREADS, 0, st>>>((const int32_t*)x, (int32_t*)o, L, TB);
  else
    loop_floor_kernel<8><<<grid, THREADS, 0, st>>>((const int32_t*)x, (int32_t*)o, L, TB);
  return (int)cudaGetLastError();
}

extern "C" int h2r_slab_scan(const void* tk, const void* classes, const void* x, void* o0,
                             void* o1, void* o2, void* o3, int L, int TB, int K, int S,
                             int chunk, void* scratch, int epoch, void* stream) {
  void* const outs[4] = {o0, o1, o2, o3};
  return probe_slab::launch<4>(tk, classes, x, outs, L, TB, K, S, 0, chunk, scratch,
                               (unsigned)epoch, (cudaStream_t)stream);
}
