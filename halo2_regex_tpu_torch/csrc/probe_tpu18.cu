// slab_anatomy -- the slab kernel's cost anatomy of tools/probe_tpu18.py
// (`kernel` of `build`, :51, pallas_call at :97) as an H100 kernel: the
// table scan's step with N_OUT = 1, 2 or 4 picks and stores a step, so
// that the extra loads and stores of a four-output step are priced
// directly.
//
// Per step: the class of the byte by the probe's thresholds (the class
// map of the byte clamped to [0, 256)), then N_OUT picks of the class
// table [kp, 4S] at s, v_j = tab[class, j * S + s], s = v_0, one output
// [L, B] int32 a pick, from the model's first state.  The probe picks with
// a one-hot bf16 product and a select sum: exact for the packed table's
// values (all in [0, 256], build_packed_tables), so this gather is the
// same function.  The kernels are probe_slab.cuh's (slab_scan's with the
// pick and store count as their parameter): chunked by default, or serial.
//
// What bounds it on the H100: in the chunked form the bytes (one read of x,
// N_OUT writes) and, for a DFA whose walks never meet to one state (the
// from: model's meet to two), the maps; in the serial one the chain of
// dependent shared-memory loads (one thread a string, blocks of 32).

#include <cstdint>
#include <cuda_runtime.h>

#include "probe_slab.cuh"

extern "C" int h2r_slab_anatomy(const void* tk, const void* classes, const void* x, void* o0,
                                void* o1, void* o2, void* o3, int L, int TB, int K, int S,
                                int first, int n_out, int chunk, void* scratch, int epoch,
                                void* stream) {
  void* const outs[4] = {o0, o1, o2, o3};
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned ep = (unsigned)epoch;
  switch (n_out) {
    case 1:
      return probe_slab::launch<1>(tk, classes, x, outs, L, TB, K, S, first, chunk, scratch, ep, st);
    case 2:
      return probe_slab::launch<2>(tk, classes, x, outs, L, TB, K, S, first, chunk, scratch, ep, st);
    case 4:
      return probe_slab::launch<4>(tk, classes, x, outs, L, TB, K, S, first, chunk, scratch, ep, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
