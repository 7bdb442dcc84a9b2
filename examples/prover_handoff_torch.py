"""Prover hand-off example on the PyTorch port: emit the witness rows for
an external halo2 consumer and re-verify them from the text alone.  The
counterpart of examples/prover_handoff.py, host only, as it is.

The reference wires tables and advice straight into halo2's Layouter
(src/table.rs:61-196, src/lib.rs:311-773) and smoke-tests a real
keygen→prove→verify round (src/lib.rs:1152-1197).  The port's equivalent
hand-off is the same self-describing row dump (witness/handoff.py): run a
match, dump, then parse + constraint-check the dump exactly as an external
consumer would — from the text, with no package model objects.

    python examples/prover_handoff_torch.py [output.txt]

Its dump equals the JAX example's byte for byte.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.setrecursionlimit(100_000)

from halo2_regex_tpu_torch.compiler.decomposed import DecomposedRegexConfig
from halo2_regex_tpu_torch.models.compiled import CompiledRegexModel
from halo2_regex_tpu_torch.ops import reference as ref_ops
from halo2_regex_tpu_torch.witness.handoff import (
    dump_prover_rows,
    load_prover_rows,
    verify_handoff,
)

CONFIG = {
    "max_byte_size": 64,
    "parts": [
        {"is_public": False, "regex_def": "order id: ", "max_size": 10},
        {
            "is_public": True,
            "regex_def": "(0|1|2|3|4|5|6|7|8|9)+",
            "max_size": 8,
        },
        {"is_public": False, "regex_def": " done.", "max_size": 6},
    ],
}
INPUT = b"order id: 123456 done."


def main(out_path: str | None = None) -> int:
    cfg = DecomposedRegexConfig.from_json(CONFIG)
    model = CompiledRegexModel.from_decomposed(cfg, max_chars_size=64)

    # 1. produce the witness (any backend; the oracle keeps this example on
    #    the host — the card's matchers emit bit-identical columns)
    result = ref_ops.match_substrs(model.regex_defs, INPUT, 64)
    assert bool(result.match_ok)

    # 2. dump tables + assigned columns in the reference's row orders
    text = dump_prover_rows(
        model.regex_defs,
        result,
        meta={"input": INPUT.decode(), "max_chars_size": "64"},
    )
    if out_path:
        Path(out_path).write_text(text)
        print(f"wrote {out_path} ({len(text.splitlines())} lines)")

    # 3. consume as an external prover would: parse the text, re-check the
    #    gates and lookup memberships against the table sections
    sections = load_prover_rows(text)
    errors = verify_handoff(sections)
    assert not errors, errors
    masked = bytes(int(v) for v in sections["instance masked_characters"] if v)
    print(f"hand-off verified: {len(sections)} sections, extracted {masked!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else None))
