// Host oracle of the port: the per-def DFA scan, the substring tagging and
// the mask FSMs over a padded batch, on the model's dense tables.  Copies of
// h2r_scan_states, h2r_substr_scan and h2r_mask_fsm from
// halo2_regex_tpu/native/scan.cpp (the port carries its own copy; the JAX
// package's native module is not imported), with a C ABI for ctypes.  It is
// a conformance oracle for whole batches, not a path of the device.
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17, with pack.cpp, into one
// library (native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Sequential DFA scan over a padded batch.
//   chars:      [batch, max_len] input bytes
//   lengths:    [batch]
//   transition: [256, s] dense next-state table (DEAD-completed)
//   states_out: [batch, max_len + 1]; row `len` keeps the final state and
//               rows beyond carry `dummy_state` (lib.rs:404-418 semantics)
void h2r_scan_states(const uint8_t* chars, const int32_t* lengths,
                     int64_t batch, int64_t max_len, const int32_t* transition,
                     int32_t s, int32_t first_state, int32_t dummy_state,
                     int32_t* states_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* row = chars + b * max_len;
    int32_t* out = states_out + b * (max_len + 1);
    int32_t st = first_state;
    out[0] = st;
    int64_t len = lengths[b];
    for (int64_t i = 0; i < len; ++i) {
      st = transition[(int64_t)row[i] * s + st];
      out[i + 1] = st;
    }
    for (int64_t i = len + 1; i <= max_len; ++i) out[i] = dummy_state;
  }
}

// Substring-id tagging + start/end flags for one def.
//   states:        [batch, max_len + 1] from h2r_scan_states
//   substr_table:  [s, s]  (cur, next) -> global substr id (0 = none)
//   is_start_tab / is_end_tab: [n_ids, s] membership tables (row 0 zero)
//   ids_out:       [batch, max_len]
//   is_start_out / is_end_out: [batch, max_len + 1] (is_end right-shifted)
void h2r_substr_scan(const int32_t* states, const int32_t* lengths,
                     int64_t batch, int64_t max_len, const int32_t* substr_table,
                     int32_t s, const uint8_t* is_start_tab,
                     const uint8_t* is_end_tab, int64_t n_ids,
                     int32_t* ids_out, int32_t* is_start_out,
                     int32_t* is_end_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t* st = states + b * (max_len + 1);
    int32_t* ids = ids_out + b * max_len;
    int32_t* iso = is_start_out + b * (max_len + 1);
    int32_t* ieo = is_end_out + b * (max_len + 1);
    int64_t len = lengths[b];
    std::memset(ids, 0, sizeof(int32_t) * max_len);
    std::memset(iso, 0, sizeof(int32_t) * (max_len + 1));
    std::memset(ieo, 0, sizeof(int32_t) * (max_len + 1));
    for (int64_t i = 0; i < len; ++i) {
      int32_t id = substr_table[(int64_t)st[i] * s + st[i + 1]];
      ids[i] = id;
      iso[i] = is_start_tab[(int64_t)id * s + st[i]];
      ieo[i + 1] = is_end_tab[(int64_t)id * s + st[i + 1]];
    }
  }
}

// Forward + backward set/reset/hold mask FSMs over summed columns
// (lib.rs:598-714). All arrays [batch, max_len] except the flag sums which
// are [batch, max_len + 1].
void h2r_mask_fsm(const int32_t* id_sum, const int32_t* is_start_sum,
                  const int32_t* is_end_sum, int64_t batch, int64_t max_len,
                  int32_t* fwd_out, int32_t* bwd_out, int32_t* mask_out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t* ids = id_sum + b * max_len;
    const int32_t* iss = is_start_sum + b * (max_len + 1);
    const int32_t* ies = is_end_sum + b * (max_len + 1);
    int32_t* fwd = fwd_out + b * max_len;
    int32_t* bwd = bwd_out + b * max_len;
    int32_t* msk = mask_out + b * max_len;
    int32_t last = 0;
    for (int64_t i = 0; i < max_len; ++i) {
      int32_t pre = (i > 0) ? ids[i - 1] : 0;
      bool changed = pre != ids[i];
      bool set_f = iss[i] && changed;
      bool reset_f = !iss[i] && ies[i] && changed;
      last = set_f ? 1 : (reset_f ? 0 : last);
      fwd[i] = last;
    }
    last = 0;
    for (int64_t idx = 0; idx < max_len; ++idx) {
      int64_t j = max_len - 1 - idx;
      int32_t pre = (idx > 0) ? ids[j + 1] : 0;
      bool changed = pre != ids[j];
      bool set_f = ies[j + 1] && changed;
      bool reset_f = !ies[j + 1] && iss[j + 1] && changed;
      last = set_f ? 1 : (reset_f ? 0 : last);
      bwd[j] = last;
    }
    for (int64_t i = 0; i < max_len; ++i) msk[i] = fwd[i] & bwd[i];
  }
}

}  // extern "C"
