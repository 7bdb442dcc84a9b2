"""Constraint checker — the framework's MockProver equivalent.

Verifies a :class:`~halo2_regex_tpu.witness.result.RegexResult` witness
against the reference circuit's constraint system (reference:
src/lib.rs:173-285):

  gate (i)   first row: enable boolean; if enabled, each def's state equals
             its first state (lib.rs:173-191);
  gate (ii)  other rows: enable boolean and non-increasing 1->1,1->0,0->0
             (lib.rs:193-204);
  lookup (iii) per def/row: (enable*char, enable*cur + !enable*dummy,
             enable*next + !enable*dummy, enable*substr_id) must be a
             transition-table row (lib.rs:207-233);
  lookup (iv) substring start: (start_enable*substr_id,
             start_enable*cur + disable*dummy, dummy) in endpoints
             (lib.rs:235-258);
  lookup (v)  substring end: (end_enable*substr_id, dummy,
             end_enable*next + disable*dummy) in endpoints (lib.rs:260-284);
  acceptance  at every row, flag_change*(state==accepted) + (1-flag_change)
             == 1 (lib.rs:427-457).

The reference's MockProver checks these per-row on the assigned columns; we
do the same vectorized in numpy. A failing check returns a list of
violation strings (empty == the witness verifies).  The port's copy takes a
result whose fields are tensors on any device (the card's included) or
numpy arrays.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..models.defs import RegexDefs
from .result import RegexResult, host
from .tables import build_all_tables


def _encode(*cols) -> np.ndarray:
    """Pack lookup-row columns into one int64 key (each value < 2^20)."""
    acc = np.zeros_like(np.asarray(cols[0], np.int64))
    for c in cols:
        acc = (acc << 20) | np.asarray(c, np.int64)
    return acc


def check_witness_batch(
    regex_defs: List[RegexDefs], result: RegexResult
) -> np.ndarray:
    """Vectorized verification of a BATCHED witness: returns a bool array
    [B] (True = every gate/lookup/acceptance constraint holds for that
    row). Same semantics as :func:`check_witness`, suitable for large L
    and corpus-scale batches."""
    enable = host(result.all_enable_flags)
    chars = host(result.all_characters)
    states = host(result.states)
    ids = host(result.substr_ids_per_def)
    start_enable = host(result.start_enable)
    end_enable = host(result.end_enable)
    squeeze = enable.ndim == 1
    if squeeze:
        enable, chars = enable[None], chars[None]
        states, ids = states[None], ids[None]
        start_enable, end_enable = start_enable[None], end_enable[None]
    B, mx = enable.shape
    ok = np.ones(B, bool)

    # gates: boolean and non-increasing enables
    ok &= np.isin(enable, (0, 1)).all(axis=1)
    ok &= (np.diff(enable, axis=1) <= 0).all(axis=1)

    tables = build_all_tables(regex_defs)
    for d, defs in enumerate(regex_defs):
        dummy = defs.allstr.largest_state_val + 1
        trans, ends = tables[d]
        # gate (i): first-row state
        ok &= (enable[:, 0] == 0) | (states[:, d, 0] == defs.allstr.first_state_val)

        # lookup (iii)
        en = enable
        keys = _encode(
            en * chars,
            en * states[:, d, :mx] + (1 - en) * dummy,
            en * states[:, d, 1:] + (1 - en) * dummy,
            en * ids[:, d],
        )
        table_keys = _encode(
            trans.characters, trans.cur_states, trans.next_states, trans.substr_ids
        )
        ok &= np.isin(keys, table_keys).all(axis=1)

        # lookups (iv)/(v)
        se = start_enable[:, d]
        keys = _encode(se * ids[:, d], se * states[:, d, :mx] + (1 - se) * dummy,
                       np.full_like(se, dummy))
        end_keys = _encode(ends.substr_ids, ends.start_states, ends.end_states)
        ok &= np.isin(keys, end_keys).all(axis=1)
        ee = end_enable[:, d]
        keys = _encode(ee * ids[:, d], np.full_like(ee, dummy),
                       ee * states[:, d, 1:] + (1 - ee) * dummy)
        ok &= np.isin(keys, end_keys).all(axis=1)

        # acceptance at every enable boundary
        pre = np.concatenate([np.ones((B, 1), enable.dtype), enable], axis=1)
        cur = np.concatenate([enable, np.zeros((B, 1), enable.dtype)], axis=1)
        boundary = (pre - cur) == 1
        acc = np.isin(states[:, d], defs.accept_set)
        ok &= (~boundary | acc).all(axis=1)
    return ok if not squeeze else ok[:1]


def check_witness(
    regex_defs: List[RegexDefs], result: RegexResult, max_len_check: bool = True
) -> List[str]:
    """Run all constraint checks on a non-batched witness. Returns the list
    of violations (empty means the proof obligation holds)."""
    errors: List[str] = []
    enable = host(result.all_enable_flags)
    chars = host(result.all_characters)
    states = host(result.states)
    ids = host(result.substr_ids_per_def)
    start_enable = host(result.start_enable)
    end_enable = host(result.end_enable)
    mx = enable.shape[-1]
    tables = build_all_tables(regex_defs)

    # gate (i): first row
    if enable[0] not in (0, 1):
        errors.append(f"gate(i): enable[0]={enable[0]} not boolean")
    for d, defs in enumerate(regex_defs):
        if enable[0] == 1 and states[d, 0] != defs.allstr.first_state_val:
            errors.append(
                f"gate(i): def {d} state[0]={states[d,0]} != first "
                f"{defs.allstr.first_state_val}"
            )

    # gate (ii): enable transitions
    for i in range(1, mx):
        if enable[i] not in (0, 1):
            errors.append(f"gate(ii): enable[{i}]={enable[i]} not boolean")
        change = enable[i - 1] - enable[i]
        if change not in (0, 1):
            errors.append(f"gate(ii): enable change {enable[i-1]}->{enable[i]} at {i}")

    for d, defs in enumerate(regex_defs):
        dummy = defs.allstr.largest_state_val + 1
        trans, ends = tables[d]
        trans_set = set(trans.as_rows())
        ends_set = set(ends.as_rows())

        # lookup (iii)
        for i in range(mx):
            en = int(enable[i])
            row = (
                en * int(chars[i]),
                en * int(states[d, i]) + (1 - en) * dummy,
                en * int(states[d, i + 1]) + (1 - en) * dummy,
                en * int(ids[d, i]),
            )
            if row not in trans_set:
                errors.append(f"lookup(iii): def {d} row {i}: {row} not in table")

        # lookup (iv): start endpoints
        for i in range(mx):
            se = int(start_enable[d, i])
            row = (
                se * int(ids[d, i]),
                se * int(states[d, i]) + (1 - se) * dummy,
                dummy,
            )
            if row not in ends_set:
                errors.append(f"lookup(iv): def {d} row {i}: {row} not in endpoints")

        # lookup (v): end endpoints
        for i in range(mx):
            ee = int(end_enable[d, i])
            row = (
                ee * int(ids[d, i]),
                dummy,
                ee * int(states[d, i + 1]) + (1 - ee) * dummy,
            )
            if row not in ends_set:
                errors.append(f"lookup(v): def {d} row {i}: {row} not in endpoints")

        # acceptance at the enable boundary (lib.rs:427-457), extended to the
        # row-max boundary for full-length inputs (SURVEY §8.4).
        for i in range(mx + 1):
            pre = 1 if i == 0 else int(enable[i - 1])
            cur = 0 if i == mx else int(enable[i])
            flag_change = pre - cur
            if flag_change == 1 and int(states[d, i]) not in defs.accept_set:
                errors.append(
                    f"acceptance: def {d} boundary at row {i}: state "
                    f"{states[d,i]} not in accept set {sorted(defs.accept_set)}"
                )
    return errors


def verify(regex_defs: List[RegexDefs], result: RegexResult) -> bool:
    """True iff the witness satisfies every constraint."""
    return not check_witness(regex_defs, result)
