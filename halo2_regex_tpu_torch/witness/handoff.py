"""Prover hand-off: a self-describing row dump an external halo2 consumer
can ingest without reading this package.

The reference's proving hand-off is implicit: ``RegexTableConfig::load``
fills the fixed lookup tables (reference: src/table.rs:61-196) and
``match_substrs`` assigns the advice columns (src/lib.rs:311-773) directly
into the halo2 ``Layouter``; its keygen→prove→verify smoke test is
src/lib.rs:1152-1197.  Here the same rows are emitted as a documented text
artifact:

    # halo2-regex-tpu prover handoff v1
    # <metadata comments>
    [table transition def=D]   rows: "char cur next substr_id"
                               (dummy row first, then allstr-file line
                               order — the table.rs:102-108 sort)
    [table endpoints def=D]    rows: "substr_id start end"
    [advice characters]        one int per circuit row (enable-masked)
    [advice char_enable]
    [advice states def=D]      max_chars_size+1 rows; row len carries the
                               final state, dummy beyond (lib.rs:404-418)
    [advice substr_ids def=D]
    [advice start_enable def=D]
    [advice end_enable def=D]
    [instance masked_characters]
    [instance all_substr_ids]

Every advice tuple feeds the reference's lookup arguments (iii)(iv)(v)
(lib.rs:207-284) against the table sections; ``verify_handoff`` re-checks
that membership from the PARSED text alone (no package model objects), the
way an external consumer would.  ``examples/prover_handoff.py`` shows the
full flow.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..models.defs import RegexDefs
from .result import RegexResult
from .tables import build_all_tables

MAGIC = "# halo2-regex-tpu prover handoff v1"


def dump_prover_rows(
    regex_defs: List[RegexDefs],
    result: RegexResult,
    meta: Dict[str, str] | None = None,
) -> str:
    """Serialize the fixed tables + assigned columns of one (non-batched)
    witness in the reference's row orders."""
    r = result.to_numpy()
    n_defs = len(regex_defs)
    out = [MAGIC]
    for k, v in (meta or {}).items():
        out.append(f"# {k}: {v}")
    tables = build_all_tables(regex_defs)
    for d, (trans, ends) in enumerate(tables):
        out.append(f"[table transition def={d}]")
        out += [" ".join(map(str, row)) for row in trans.as_rows()]
        out.append(f"[table endpoints def={d}]")
        out += [" ".join(map(str, row)) for row in ends.as_rows()]

    def col(name: str, values) -> None:
        out.append(f"[{name}]")
        out.extend(str(int(v)) for v in np.asarray(values).ravel())

    col("advice characters", r.all_characters)
    col("advice char_enable", r.all_enable_flags)
    for d in range(n_defs):
        col(f"advice states def={d}", r.states[d])
        col(f"advice substr_ids def={d}", r.substr_ids_per_def[d])
        col(f"advice start_enable def={d}", r.start_enable[d])
        col(f"advice end_enable def={d}", r.end_enable[d])
    col("instance masked_characters", r.masked_characters)
    col("instance all_substr_ids", r.all_substr_ids)
    return "\n".join(out) + "\n"


def load_prover_rows(text: str) -> Dict[str, np.ndarray]:
    """Parse a hand-off dump into ``{section name: int32 array}`` (tables
    as [rows, width], columns as [rows])."""
    lines = text.splitlines()
    if not lines or lines[0] != MAGIC:
        raise ValueError("not a prover handoff v1 file")
    sections: Dict[str, List[List[int]]] = {}
    cur: List[List[int]] | None = None
    for ln in lines[1:]:
        if not ln or ln.startswith("#"):
            continue
        if ln.startswith("["):
            cur = sections.setdefault(ln.strip("[]"), [])
        else:
            if cur is None:
                raise ValueError(f"data before first section: {ln!r}")
            cur.append([int(x) for x in ln.split()])
    out: Dict[str, np.ndarray] = {}
    for name, rows in sections.items():
        arr = np.array(rows, np.int32)
        out[name] = arr if arr.shape[1] > 1 else arr[:, 0]
    return out


def verify_handoff(sections: Dict[str, np.ndarray]) -> List[str]:
    """Re-check, from the parsed dump alone, the constraints a halo2
    consumer would enforce: lookup (iii) transition membership, lookups
    (iv)/(v) endpoint membership (lib.rs:207-284), the enable gates
    (lib.rs:173-204), and the instance columns' mask consistency."""
    errors: List[str] = []
    n_defs = sum(
        1 for k in sections if k.startswith("table transition def=")
    )
    # structural validation first: a malformed/truncated dump must come
    # back as error entries, not a traceback (this runs on UNTRUSTED
    # external text — handoff_check.cpp enforces the same shape rules)
    required = ["advice char_enable", "advice characters",
                "instance masked_characters", "instance all_substr_ids"]
    for d in range(n_defs):
        required += [
            f"table transition def={d}", f"table endpoints def={d}",
            f"advice states def={d}", f"advice substr_ids def={d}",
            f"advice start_enable def={d}", f"advice end_enable def={d}",
        ]
    missing = [k for k in required if k not in sections]
    if n_defs == 0:
        missing.append("table transition def=0")
    if missing:
        return [f"structure: missing section {k!r}" for k in missing]
    enable = sections["advice char_enable"]
    chars = sections["advice characters"]
    mx = len(enable)
    for d in range(n_defs):
        if len(sections[f"advice states def={d}"]) != mx + 1:
            errors.append(
                f"structure: def {d} states has "
                f"{len(sections[f'advice states def={d}'])} rows, "
                f"expected {mx + 1}"
            )
        for name in (f"advice substr_ids def={d}",
                     f"advice start_enable def={d}",
                     f"advice end_enable def={d}"):
            if len(sections[name]) != mx:
                errors.append(
                    f"structure: {name} has {len(sections[name])} rows, "
                    f"expected {mx}"
                )
    for name in ("advice characters", "instance masked_characters",
                 "instance all_substr_ids"):
        if len(sections[name]) != mx:
            errors.append(
                f"structure: {name} has {len(sections[name])} rows, "
                f"expected {mx}"
            )
    if errors:
        return errors
    if enable[0] not in (0, 1):
        errors.append("gate(i): enable[0] not boolean")
    for i in range(1, mx):
        if enable[i - 1] - enable[i] not in (0, 1):
            errors.append(f"gate(ii): enable rises at row {i}")
    for d in range(n_defs):
        trans = {tuple(r) for r in sections[f"table transition def={d}"].tolist()}
        ends = {tuple(r) for r in sections[f"table endpoints def={d}"].tolist()}
        dummy = max(r[1] for r in trans)  # dummy row is (0, dummy, dummy, 0)
        states = sections[f"advice states def={d}"]
        ids = sections[f"advice substr_ids def={d}"]
        st_en = sections[f"advice start_enable def={d}"]
        en_en = sections[f"advice end_enable def={d}"]
        for i in range(mx):
            en = int(enable[i])
            tup = (
                en * int(chars[i]),
                en * int(states[i]) + (1 - en) * dummy,
                en * int(states[i + 1]) + (1 - en) * dummy,
                en * int(ids[i]),
            )
            if tup not in trans:
                errors.append(f"lookup(iii): def {d} row {i}: {tup} not in table")
            if st_en[i]:
                tup4 = (int(ids[i]), int(states[i]), dummy)
                if tup4 not in ends:
                    errors.append(f"lookup(iv): def {d} row {i}: {tup4}")
            if en_en[i]:
                tup5 = (int(ids[i]), dummy, int(states[i + 1]))
                if tup5 not in ends:
                    errors.append(f"lookup(v): def {d} row {i}: {tup5}")
    # instance consistency: masked chars/ids are enable-masked values
    m_chars = sections["instance masked_characters"]
    m_ids = sections["instance all_substr_ids"]
    for i in range(mx):
        if not enable[i] and (m_chars[i] or m_ids[i]):
            errors.append(f"instance: nonzero masked value on disabled row {i}")
        if m_chars[i] and m_chars[i] != chars[i]:
            errors.append(f"instance: masked char {m_chars[i]} != char at {i}")
    return errors
