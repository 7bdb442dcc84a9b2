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
// forms, so a warp's loads of one position are 32 (or WB) neighbouring
// words.
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
// chunked (chunk = C): a thread a (word, chunk of C positions).  A block
//   takes WB words and every chunk of their L (WB x L / C threads, at most
//   kMaxThreads; thread t: word t % WB, chunk t / WB), so a block's warps
//   hold consecutive chunks of the same words.  A thread walks its
//   chunk's HALO positions first (the cascade and the line start reach
//   back 7: re-read from L2, as the previous chunk's thread reads them
//   too), then its C positions, then AHEAD positions past it (its ds at
//   e-1 and e feed done at e+1 and e+2).  ns and v at the chunk's start are
//   unknown, but every register is AND/OR-linear in them with no term
//   holding both, so the walk carries each of ns, v, ds and done as a
//   constant and a coefficient of each carry-in (the serial form's walk
//   with both carry-ins zero is its constant part: the compiler drops the
//   coefficients there).  The chunk's summary -- ns and v at its end and
//   its OR of done, as masks -- goes to shared memory, the block composes
//   the summaries in order by a tree (log2 L/C rounds), and the first
//   chunk's thread writes the constant OR.  One pass over the stack, no
//   re-walk: the halo costs HALO + AHEAD extra class programs a chunk
//   (28 % at C = 32).

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_marker_class.cuh"
#include "probe_ring.cuh"

namespace {

constexpr int kPlanes = 10;
constexpr int HALO = 7;
constexpr int AHEAD = 2;
constexpr int kMaxThreads = 512;  // a chunked block's threads (128 registers a thread)
constexpr int kSerialThreads = 32;
constexpr int RING = 16;  // positions in the serial form's ring (RING - 1 in flight): 20 KiB

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

template <int PHASE>
__device__ __forceinline__ void walk(Walk& s, const int32_t* __restrict__ st, size_t plane,
                                     int NW, int w, int from, int to) {
#pragma unroll 2
  for (int i = from; i < to; ++i) {
    uint32_t p[kPlanes];
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) p[j] = (uint32_t)__ldg(st + j * plane + (size_t)i * NW + w);
    step<PHASE>(s, p, i == 0);
  }
}

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
marker_chunked_kernel(const int32_t* __restrict__ st, int32_t* __restrict__ out, int NW, int L,
                      int WB) {
  // chunk summaries: ns (na, nb), v (vv, vn, v0), the OR of done (o0, on, ov)
  __shared__ uint32_t sum[8][kMaxThreads];
  const int t = threadIdx.x, nch = L / C;
  const int k = t / WB, w = blockIdx.x * WB + t % WB;
  const size_t plane = (size_t)L * NW;
  const int s0 = k * C;
  Walk s;
  walk<kHalo>(s, st, plane, NW, w, max(0, s0 - HALO), s0);
  walk<kMain>(s, st, plane, NW, w, s0, s0 + C);
  walk<kAhead>(s, st, plane, NW, w, s0 + C, min(s0 + C + AHEAD, L));
  sum[0][t] = s.nsN, sum[1][t] = s.ns0, sum[2][t] = s.vV, sum[3][t] = s.vN;
  sum[4][t] = s.v0, sum[5][t] = s.o0, sum[6][t] = s.oN, sum[7][t] = s.oV;
  __syncthreads();
  // chunk k takes chunk k + h's summary after its own (h = 1, 2, 4, ...)
  for (int h = 1; h < nch; h *= 2) {
    if (k % (2 * h) == 0 && k + h < nch) {
      const int u = t + h * WB;
      const uint32_t na = sum[0][t], nb = sum[1][t], vv = sum[2][t], vn = sum[3][t];
      const uint32_t v0 = sum[4][t], o0 = sum[5][t], on = sum[6][t], ov = sum[7][t];
      const uint32_t Na = sum[0][u], Nb = sum[1][u], Vv = sum[2][u], Vn = sum[3][u];
      const uint32_t V0 = sum[4][u], O0 = sum[5][u], On = sum[6][u], Ov = sum[7][u];
      sum[0][t] = Na & na;
      sum[1][t] = (Na & nb) | Nb;
      sum[2][t] = Vv & vv;
      sum[3][t] = (Vv & vn) | (Vn & na);
      sum[4][t] = (Vv & v0) | (Vn & nb) | V0;
      sum[5][t] = o0 | O0 | (On & nb) | (Ov & v0);
      sum[6][t] = on | (On & na) | (Ov & vn);
      sum[7][t] = ov | (Ov & vv);
    }
    __syncthreads();
  }
  if (k == 0) out[w] = (int32_t)sum[5][t];
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

template <int C>
int launch_chunked(const void* st, void* out, int NW, int L, int WB, cudaStream_t stream) {
  marker_chunked_kernel<C><<<NW / WB, (L / C) * WB, 0, stream>>>(
      (const int32_t*)st, (int32_t*)out, NW, L, WB);
  return (int)cudaGetLastError();
}

}  // namespace

// chunk 0: the serial form; else the chunked form with WB words a block
extern "C" int h2r_marker_match(const void* stack, void* out, int NW, int L, int chunk, int WB,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (NW <= 0 || NW % kSerialThreads || L <= 0) return (int)cudaErrorInvalidValue;
  if (chunk == 0) {
    marker_serial_kernel<<<NW / kSerialThreads, kSerialThreads, 0, s>>>(
        (const int32_t*)stack, (int32_t*)out, NW, L);
    return (int)cudaGetLastError();
  }
  if (chunk < 0 || L % chunk || WB <= 0 || 32 % WB || (L / chunk) * WB > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 8: return launch_chunked<8>(stack, out, NW, L, WB, s);
    case 16: return launch_chunked<16>(stack, out, NW, L, WB, s);
    case 32: return launch_chunked<32>(stack, out, NW, L, WB, s);
    case 64: return launch_chunked<64>(stack, out, NW, L, WB, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
