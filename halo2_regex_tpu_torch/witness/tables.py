"""Witness lookup-table row emission.

Builds, per ``RegexDefs``, the fixed lookup-table rows that the reference
loads into its circuit (reference: src/table.rs:61-198):

  - the transition table: a dummy row ``(0, dummy, dummy, 0)`` followed by
    one row ``(char, cur, next, substr_id)`` per DFA transition, ordered by
    the transition's original line index in the allstr text file — the
    reference sorts by that index for deterministic verification keys
    (table.rs:102-108);
  - the endpoints table: a dummy row ``(0, dummy, dummy)`` followed by
    ``(substr_id, start, dummy)`` rows then ``(substr_id, dummy, end)``
    rows per substr, in file order (table.rs:149-193).

Global substr_id numbering starts at 1 and accumulates across defs
(table.rs:61-66, lib.rs:780-784).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..models.defs import RegexDefs


@dataclass
class TransitionTable:
    """Columns of the per-def transition lookup table (table.rs:17-20)."""

    characters: np.ndarray  # int32 [rows]
    cur_states: np.ndarray
    next_states: np.ndarray
    substr_ids: np.ndarray

    def as_rows(self) -> List[Tuple[int, int, int, int]]:
        return list(
            zip(
                self.characters.tolist(),
                self.cur_states.tolist(),
                self.next_states.tolist(),
                self.substr_ids.tolist(),
            )
        )


@dataclass
class EndpointsTable:
    """Columns of the per-def endpoints lookup table (table.rs:21-23)."""

    substr_ids: np.ndarray  # int32 [rows]
    start_states: np.ndarray
    end_states: np.ndarray

    def as_rows(self) -> List[Tuple[int, int, int]]:
        return list(
            zip(
                self.substr_ids.tolist(),
                self.start_states.tolist(),
                self.end_states.tolist(),
            )
        )


def build_transition_table(
    defs: RegexDefs, substr_id_offset: int
) -> Tuple[TransitionTable, int]:
    """table.rs:68-125. Returns the table and the next substr_id offset."""
    dummy = defs.allstr.largest_state_val + 1
    rows = [(0, dummy, dummy, 0)]
    # Sort by original line index for deterministic ordering (table.rs:102-108).
    lookups = sorted(defs.allstr.state_lookup.items(), key=lambda kv: kv[1][0])
    for (char, cur), (_, nxt) in lookups:
        substr_id = 0
        for j, substr in enumerate(defs.substrs):
            if (cur, nxt) in substr.valid_state_transitions:
                substr_id = substr_id_offset + j
                break
        rows.append((char, cur, nxt, substr_id))
    arr = np.array(rows, np.int32)
    return (
        TransitionTable(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]),
        substr_id_offset + len(defs.substrs),
    )


def build_endpoints_table(defs: RegexDefs, substr_id_offset: int) -> EndpointsTable:
    """table.rs:126-196."""
    dummy = defs.allstr.largest_state_val + 1
    rows = [(0, dummy, dummy)]
    for idx, substr in enumerate(defs.substrs):
        substr_id = substr_id_offset + idx
        for start in substr.start_states:
            rows.append((substr_id, start, dummy))
        for end in substr.end_states:
            rows.append((substr_id, dummy, end))
    arr = np.array(rows, np.int32)
    return EndpointsTable(arr[:, 0], arr[:, 1], arr[:, 2])


def build_all_tables(regex_defs: List[RegexDefs]):
    """Load-order equivalent of RegexVerifyConfig::load (lib.rs:779-785):
    one (transition, endpoints) pair per def with accumulated offsets."""
    out = []
    offset = 1
    for defs in regex_defs:
        trans, next_offset = build_transition_table(defs, offset)
        ends = build_endpoints_table(defs, offset)
        out.append((trans, ends))
        offset = next_offset
    return out
