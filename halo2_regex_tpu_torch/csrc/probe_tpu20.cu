// bitop_scan -- the serial bit-op scan of tools/probe_tpu20.py (A) as an
// H100 kernel: what a step of N_OPS dependent and/or/xor ops on 32-bit
// words costs on this card, at the bitplane scan's (K2's) geometry.
//
// Replaces the TPU kernel made by make_scan_probe (tools/probe_tpu20.py:42,
// pallas_call at :74).  Per word (32 strings) and step i of L: the SB
// state planes and the running acc go through N_OPS ops, op t reading
// plane t % SB and class plane t % K of step i:
//   t % 3 == 0: acc ^= plane & cls
//   t % 3 == 1: acc |= plane & ~cls
//   t % 3 == 2: plane = plane ^ acc (later ops of the step read it);
// then out[i] = acc.  The planes carry across all of L; acc restarts from
// plane 0 at the first step of every chunk of LC steps (the probe's
// fori_loop over a grid step starts from st_scr[0]).  The probe zeroes its
// planes at the first grid step, and every op keeps an all-zero state at
// zero; here the start planes st0 are an input (zeros reproduce the probe),
// so that a compiler cannot fold the loop away.
//
// What bounds it on the H100: the dependent chain through acc (each op is
// one LOP3 on it, N_OPS a step), not bytes or operations.  One thread owns
// one word and walks all L steps; blocks of 32 threads, as
// bitplane_scan.cu's launch: at NW = 1024 words (the probe's 8 x 128, K2's
// B = 32768) that is 32 warps, one on each of 32 SMs.  N_OPS, SB and K are
// template parameters and the op loop is unrolled fully, so every op t's
// t % 3, t % SB and t % K is a constant and the planes stay in registers.  The
// class words of the next RING - 1 steps are in flight to a shared-memory
// ring (probe_ring.cuh, K2's design), so a step waits on its chain alone.
//
// Layouts: cls [L, K, NWS, 128] int32; st0 [SB, NWS, 128] int32; out [L,
// 1, NWS, 128] int32; NW = NWS * 128 words.
//
// bitop_carry, the carry mode, replaces probe_tpu20.py's E (kern2 :246,
// pallas_call at :267): per string group b and word w, a state carried
// across the chunks of LC positions, st ^= c & st for `steps` positions at
// the start of each chunk (the probe as written reads one, the first: its
// loop runs cls_ref.shape[0] = 1 trip), out[b, w] = st after the last
// chunk.  The probe starts each b from its zeroed scratch, which the op
// keeps at zero; here the start st0 [NW] is an input, as bitop_scan's.
// steps = LC is the carry scan the probe meant: every position in order.
// The TPU carried st in VMEM scratch across the grid's chunk axis; here
// one thread owns one (b, w) and walks its chunks itself, the positions'
// words in flight through the same ring.  What bounds it: the chain, one
// LOP3 a position.  Layouts: cls [NB, L, NW] int32 (the probe's [NB, L, 1,
// NWS, 128]); st0 [NW]; out [NB, NW]; L % LC == 0, 1 <= steps <= LC.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_ring.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int RING = 16;  // steps of class words in the ring (RING - 1 in flight): 24 KiB

template <int N_OPS, int SB, int K>
__global__ void __launch_bounds__(THREADS)
bitop_scan_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                  int32_t* __restrict__ out, int NW, int L, int LC) {
  __shared__ uint32_t ring[RING][K][THREADS];  // step p's class words in slot p % RING
  const int t = threadIdx.x;
  const int w = blockIdx.x * THREADS + t;
  if (w >= NW) return;
  auto fetch = [&](int p) {  // an empty group past L
    if (p < L) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        probe_ring::copy4(&ring[p % RING][c][t], cls + ((size_t)p * K + c) * NW + w);
    }
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  uint32_t planes[SB];
#pragma unroll
  for (int j = 0; j < SB; ++j) planes[j] = (uint32_t)st0[(size_t)j * NW + w];
  uint32_t acc = 0;
  int in_chunk = 0;
#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    fetch(i + RING - 1);  // into slot (i - 1) % RING, read at i - 1
    probe_ring::wait_oldest<RING>();
    uint32_t cw[K];
#pragma unroll
    for (int c = 0; c < K; ++c) cw[c] = ring[i % RING][c][t];
    if (in_chunk == 0) acc = planes[0];
    if (++in_chunk == LC) in_chunk = 0;
#pragma unroll
    for (int op = 0; op < N_OPS; ++op) {
      const uint32_t a = planes[op % SB], c = cw[op % K];
      if (op % 3 == 0)
        acc ^= a & c;
      else if (op % 3 == 1)
        acc |= a & ~c;
      else
        planes[op % SB] = a ^ acc;
    }
    out[(size_t)i * NW + w] = (int32_t)acc;
  }
  probe_ring::wait_all();
}

template <int N_OPS>
int launch(const void* cls, const void* st0, void* out, int NW, int L, int LC,
           cudaStream_t stream) {
  bitop_scan_kernel<N_OPS, 5, 12><<<(NW + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const int32_t*)cls, (const int32_t*)st0, (int32_t*)out, NW, L, LC);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
bitop_carry_kernel(const int32_t* __restrict__ cls, const int32_t* __restrict__ st0,
                   int32_t* __restrict__ out, int NW, int L, int LC, int steps) {
  __shared__ uint32_t ring[RING][THREADS];  // position p's word in slot p % RING
  const int t = threadIdx.x, b = blockIdx.y;
  const int w = blockIdx.x * THREADS + t;
  if (w >= NW) return;
  const int n_pos = L / LC * steps;
  const int32_t* base = cls + (size_t)b * L * NW + w;
  auto fetch = [&](int p) {  // the p-th position read: chunk p / steps, its (p % steps)-th
    if (p < n_pos)
      probe_ring::copy4(&ring[p % RING][t], base + ((size_t)(p / steps) * LC + p % steps) * NW);
    probe_ring::commit();
  };
  for (int p = 0; p < RING - 1; ++p) fetch(p);
  uint32_t st = (uint32_t)st0[w];
#pragma unroll 1
  for (int p = 0; p < n_pos; ++p) {
    fetch(p + RING - 1);  // into slot (p - 1) % RING, read at p - 1
    probe_ring::wait_oldest<RING>();
    const uint32_t c = ring[p % RING][t];
    st ^= c & st;
  }
  out[(size_t)b * NW + w] = (int32_t)st;
  probe_ring::wait_all();
}

}  // namespace

extern "C" int h2r_bitop_carry(const void* cls, const void* st0, void* out, int NB, int NW,
                               int L, int LC, int steps, void* stream) {
  if (NB <= 0 || NB > 65535 || NW <= 0 || LC < 1 || L < LC || L % LC || steps < 1 ||
      steps > LC)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((NW + THREADS - 1) / THREADS, NB);
  bitop_carry_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cls, (const int32_t*)st0, (int32_t*)out, NW, L, LC, steps);
  return (int)cudaGetLastError();
}

// the probe's sweep: n_ops in {96, 192, 384, 768}, sb = 5, k = 12
extern "C" int h2r_bitop_scan(const void* cls, const void* st0, void* out, int n_ops, int NW,
                              int L, int LC, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (LC < 1) return (int)cudaErrorInvalidValue;
  switch (n_ops) {
    case 96: return launch<96>(cls, st0, out, NW, L, LC, st);
    case 192: return launch<192>(cls, st0, out, NW, L, LC, st);
    case 384: return launch<384>(cls, st0, out, NW, L, LC, st);
    case 768: return launch<768>(cls, st0, out, NW, L, LC, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
