"""End-to-end example on the PyTorch port: the counterpart of
examples/extract_email.py (and of the reference's examples/regex.rs).

Compiles the same decomposed config ("email was meant for @" + lowercase+
+ "."), matches "email was meant for @vitalik." with ``BatchMatcher`` (on
the card: the table scan kernel) and asserts the masked characters /
substr ids equal the expected public-instance values (reference:
examples/regex.rs:150-207), then checks the witness against every gate.

Run:  python examples/extract_email_torch.py               # on the card
      python examples/extract_email_torch.py --device cpu  # plain versions
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.setrecursionlimit(100_000)

import numpy as np

import halo2_regex_tpu_torch as h2r

MAX_STRING_LEN = 128  # regex.rs:20

CONFIG = {
    "max_byte_size": 128,
    "parts": [
        {"is_public": False, "regex_def": "email was meant for @", "max_size": 21},
        {
            "is_public": True,
            "regex_def": "(a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p|q|r|s|t|u|v|w|x|y|z)+",
            "max_size": 7,
            "solidity": {"type": "String"},
        },
        {"is_public": False, "regex_def": ".", "max_size": 1},
    ],
}


def main(device: str = "cuda") -> int:
    cfg = h2r.DecomposedRegexConfig.from_json(CONFIG)
    model = h2r.CompiledRegexModel.from_decomposed(cfg, max_chars_size=MAX_STRING_LEN)
    matcher = h2r.BatchMatcher(model, device=device)  # raises without CUDA unless "cpu"

    characters = b"email was meant for @vitalik."
    result = matcher.match_one(characters)  # numpy rows

    # Expected public instances (regex.rs:193-199): "vitalik" at offset 21.
    expected_chars = np.zeros(MAX_STRING_LEN, np.int64)
    expected_ids = np.zeros(MAX_STRING_LEN, np.int64)
    offset = 21
    for i, ch in enumerate(b"vitalik"):
        expected_chars[offset + i] = ch
        expected_ids[offset + i] = 1

    assert bool(result.match_ok), "input must satisfy the regex"
    np.testing.assert_array_equal(np.asarray(result.masked_characters), expected_chars)
    np.testing.assert_array_equal(np.asarray(result.all_substr_ids), expected_ids)

    # The MockProver-equivalent check: the full witness satisfies every
    # gate and lookup of the verification circuit.
    assert h2r.verify(model.regex_defs, result), "witness must verify"

    print("extracted:", h2r.extract_substrings(result))
    print("witness verifies: True")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sys.exit(main(ap.parse_args().device))
