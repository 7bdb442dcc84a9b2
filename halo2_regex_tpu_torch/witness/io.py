"""Witness artifact serialization.

Bundles a batch :class:`RegexResult` (the assigned advice-column values,
reference lib.rs:311-773) together with the fixed lookup tables
(table.rs:61-198) into one npz artifact — the hand-off format to a proving
backend, and the framework's witness checkpoint (SURVEY §5.4: the
reference's text tables are its de-facto serialization layer; witnesses
get the same treatment here).  The npz layout is the JAX package's, so a
file saved by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

from ..models.defs import RegexDefs
from .result import RegexResult, host
from .tables import build_all_tables


def save_witness(path, regex_defs: List[RegexDefs], result: RegexResult) -> None:
    arrays = {}
    for name in result.field_names():
        arrays[f"w_{name}"] = host(getattr(result, name))
    tables = build_all_tables(regex_defs)
    for d, (trans, ends) in enumerate(tables):
        arrays[f"t{d}_characters"] = trans.characters
        arrays[f"t{d}_cur_states"] = trans.cur_states
        arrays[f"t{d}_next_states"] = trans.next_states
        arrays[f"t{d}_substr_ids"] = trans.substr_ids
        arrays[f"e{d}_substr_ids"] = ends.substr_ids
        arrays[f"e{d}_start_states"] = ends.start_states
        arrays[f"e{d}_end_states"] = ends.end_states
    meta = {
        "n_defs": len(regex_defs),
        "fields": result.field_names(),
        "allstr_texts": [d.allstr.to_text() for d in regex_defs],
        "substr_texts": [[s.to_text() for s in d.substrs] for d in regex_defs],
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_witness(path):
    """Returns (regex_defs, RegexResult, tables_dict)."""
    from ..models.defs import AllstrRegexDef, SubstrRegexDef

    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        regex_defs = [
            RegexDefs(
                allstr=AllstrRegexDef.read_from_str(a),
                substrs=[SubstrRegexDef.read_from_str(s) for s in subs],
            )
            for a, subs in zip(meta["allstr_texts"], meta["substr_texts"])
        ]
        result = RegexResult(**{name: z[f"w_{name}"] for name in meta["fields"]})
        tables = {
            k: z[k]
            for k in z.files
            if k.startswith(("t", "e")) and not k.startswith("meta")
        }
        return regex_defs, result, tables
