// Standalone prover hand-off verifier (external-consumer demonstration),
// the port's copy of halo2_regex_tpu/native/handoff_check.cpp.
//
// Reads a witness/handoff.py v1 dump from argv[1] and re-checks, with no
// dependency on the Python package, exactly what a halo2 consumer would
// enforce when wiring these rows into the reference circuit
// (reference: src/lib.rs:173-284):
//   gate (i)/(ii): enable boolean, non-increasing;
//   lookup (iii):  (en*char, en*cur + !en*dummy, en*next + !en*dummy,
//                   en*substr_id) in the transition table;
//   lookups (iv)/(v): start/end endpoint membership;
//   instance consistency: masked columns are enable-masked.
//
// Build:  g++ -O3 -std=c++17 -o handoff_check handoff_check.cpp
// Usage:  ./handoff_check rows.txt        (exit 0 = clean)
//
// This is the framework's external-prover smoke test analogue of the
// reference's keygen->prove->verify round (src/lib.rs:1152-1197): an
// independent implementation in a different language consuming only the
// committed artifact bytes.

#include <cstdint>
#include <cstdio>
#include <fstream>
#include <iostream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

using Row = std::vector<long long>;

static int run(int argc, char** argv);

int main(int argc, char** argv) {
  // malformed external input must produce a diagnostic + exit 2, never an
  // unhandled-exception abort (missing sections -> map::at, short rows ->
  // vector::at)
  try {
    return run(argc, argv);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "malformed handoff file: %s\n", e.what());
    return 2;
  }
}

static int run(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <handoff.txt>\n", argv[0]);
    return 2;
  }
  std::ifstream in(argv[1]);
  if (!in) {
    std::fprintf(stderr, "cannot open %s\n", argv[1]);
    return 2;
  }
  std::string line;
  if (!std::getline(in, line) ||
      line != "# halo2-regex-tpu prover handoff v1") {
    std::fprintf(stderr, "not a prover handoff v1 file\n");
    return 2;
  }
  std::map<std::string, std::vector<Row>> sections;
  std::vector<Row>* cur = nullptr;
  while (std::getline(in, line)) {
    if (line.empty() || line[0] == '#') continue;
    if (line[0] == '[') {
      std::string name = line.substr(1, line.size() - 2);
      cur = &sections[name];
      continue;
    }
    if (!cur) {
      std::fprintf(stderr, "data before first section\n");
      return 2;
    }
    Row row;
    std::istringstream ss(line);
    long long v;
    while (ss >> v) row.push_back(v);
    cur->push_back(row);
  }

  auto col = [&](const std::string& name) {
    std::vector<long long> out;
    for (auto& r : sections.at(name)) out.push_back(r.at(0));
    return out;
  };

  int n_defs = 0;
  while (sections.count("table transition def=" + std::to_string(n_defs)))
    n_defs++;
  if (n_defs == 0) {
    std::fprintf(stderr, "no transition tables\n");
    return 2;
  }

  auto enable = col("advice char_enable");
  auto chars = col("advice characters");
  size_t mx = enable.size();
  long long errors = 0;

  // gates (i)/(ii)
  if (enable[0] != 0 && enable[0] != 1) {
    std::fprintf(stderr, "gate(i): enable[0] not boolean\n");
    errors++;
  }
  for (size_t i = 1; i < mx; i++) {
    long long d = enable[i - 1] - enable[i];
    if (d != 0 && d != 1) {
      std::fprintf(stderr, "gate(ii): enable rises at row %zu\n", i);
      errors++;
    }
  }

  for (int d = 0; d < n_defs; d++) {
    std::string sd = std::to_string(d);
    std::set<Row> trans, ends;
    long long dummy = 0;
    for (auto& r : sections.at("table transition def=" + sd)) {
      trans.insert(r);
      if (r.at(1) > dummy) dummy = r.at(1);  // dummy row is (0,d,d,0)
    }
    for (auto& r : sections.at("table endpoints def=" + sd)) ends.insert(r);
    auto states = col("advice states def=" + sd);
    auto ids = col("advice substr_ids def=" + sd);
    auto st_en = col("advice start_enable def=" + sd);
    auto en_en = col("advice end_enable def=" + sd);
    if (states.size() != mx + 1) {
      std::fprintf(stderr, "def %d: states length %zu != %zu\n", d,
                   states.size(), mx + 1);
      return 2;
    }
    for (size_t i = 0; i < mx; i++) {
      long long en = enable[i];
      Row t = {en * chars[i], en * states[i] + (1 - en) * dummy,
               en * states[i + 1] + (1 - en) * dummy, en * ids[i]};
      if (!trans.count(t)) {
        std::fprintf(stderr,
                     "lookup(iii): def %d row %zu: (%lld,%lld,%lld,%lld)\n",
                     d, i, t[0], t[1], t[2], t[3]);
        errors++;
      }
      if (st_en[i]) {
        Row s4 = {ids[i], states[i], dummy};
        if (!ends.count(s4)) {
          std::fprintf(stderr, "lookup(iv): def %d row %zu\n", d, i);
          errors++;
        }
      }
      if (en_en[i]) {
        Row s5 = {ids[i], dummy, states[i + 1]};
        if (!ends.count(s5)) {
          std::fprintf(stderr, "lookup(v): def %d row %zu\n", d, i);
          errors++;
        }
      }
    }
  }

  auto m_chars = col("instance masked_characters");
  auto m_ids = col("instance all_substr_ids");
  for (size_t i = 0; i < mx; i++) {
    if (!enable[i] && (m_chars[i] || m_ids[i])) {
      std::fprintf(stderr, "instance: nonzero masked on disabled row %zu\n",
                   i);
      errors++;
    }
    if (m_chars[i] && m_chars[i] != chars[i]) {
      std::fprintf(stderr, "instance: masked char mismatch row %zu\n", i);
      errors++;
    }
  }

  if (errors) {
    std::fprintf(stderr, "%lld violation(s)\n", errors);
    return 1;
  }
  std::printf("handoff clean: %d def(s), %zu rows\n", n_defs, mx);
  return 0;
}
