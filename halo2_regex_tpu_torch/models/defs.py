"""Regex definition model — parity layer with the reference's defs.rs.

:class:`AllstrRegexDef`, :class:`SubstrRegexDef` and :class:`RegexDefs`
mirror the reference structs (reference: src/defs.rs:17-265) including the
text-table file formats:

Allstr file (defs.rs:39-53):
    line 0: first state id
    line 1: accepted state id (single accepted state only)
    line 2: largest state id
    line 3+: "<cur> <next> <char byte>"

Substr file (defs.rs:165-208):
    line 0: max_length
    line 1: min_position  (parsed but unused by the verifier, defs.rs:119-125)
    line 2: max_position  (parsed but unused)
    line 3: start state ids, space separated
    line 4: end state ids, space separated
    line 5+: "<cur> <next>"

The line index of each transition is retained (defs.rs:100) because the
witness transition table is emitted in original-line order for deterministic
verification artifacts (table.rs:102-108).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class AllstrRegexDef:
    """Regex that the whole input string must satisfy (defs.rs:26-36)."""

    # (char byte, cur state) -> (line index in source file, next state)
    state_lookup: Dict[Tuple[int, int], Tuple[int, int]] = field(default_factory=dict)
    first_state_val: int = 0
    accepted_state_val: int = 0
    largest_state_val: int = 0
    # Opt-in multi-accept table-format extension: line 1 may carry a
    # space-separated accepting-state LIST (the reference format holds
    # exactly one, defs.rs:31-33, silently dropping the rest for DFAs with
    # optional tails like `(x)?`). None = plain reference file.
    accept_states_ext: Optional[List[int]] = None

    @classmethod
    def read_from_text(cls, file_path) -> "AllstrRegexDef":
        with open(file_path) as f:
            return cls.read_from_reader(f)

    @classmethod
    def read_from_str(cls, text: str) -> "AllstrRegexDef":
        return cls.read_from_reader(io.StringIO(text))

    @classmethod
    def read_from_reader(cls, reader) -> "AllstrRegexDef":
        """Parse the allstr text format (defs.rs:75-110)."""
        out = cls()
        for idx, line in enumerate(reader):
            elements = [int(s) for s in line.split()]
            if idx == 0:
                out.first_state_val = elements[0]
            elif idx == 1:
                out.accepted_state_val = elements[0]
                if len(elements) > 1:  # multi-accept extension
                    out.accept_states_ext = list(elements)
            elif idx == 2:
                out.largest_state_val = elements[0]
            else:
                out.state_lookup[(elements[2], elements[0])] = (idx, elements[1])
        return out

    def to_text(self) -> str:
        """Serialize back to the allstr format, rows in line-index order."""
        rows = sorted(self.state_lookup.items(), key=lambda kv: kv[1][0])
        lines = [
            str(self.first_state_val),
            " ".join(str(a) for a in self.accept_states_ext)
            if self.accept_states_ext is not None
            else str(self.accepted_state_val),
            str(self.largest_state_val),
        ]
        for (char, cur), (_, nxt) in rows:
            lines.append(f"{cur} {nxt} {char}")
        return "\n".join(lines) + "\n"


@dataclass
class SubstrRegexDef:
    """Regex that an extracted substring must satisfy (defs.rs:115-163)."""

    max_length: int = 0
    min_position: int = 0
    max_position: int = 0
    valid_state_transitions: Set[Tuple[int, int]] = field(default_factory=set)
    start_states: List[int] = field(default_factory=list)
    end_states: List[int] = field(default_factory=list)

    @classmethod
    def read_from_text(cls, file_path) -> "SubstrRegexDef":
        with open(file_path) as f:
            return cls.read_from_reader(f)

    @classmethod
    def read_from_str(cls, text: str) -> "SubstrRegexDef":
        return cls.read_from_reader(io.StringIO(text))

    @classmethod
    def read_from_reader(cls, reader) -> "SubstrRegexDef":
        """Parse the substr text format (defs.rs:209-265)."""
        out = cls()
        for idx, line in enumerate(reader):
            elements = [int(s) for s in line.split()]
            if idx == 0:
                out.max_length = elements[0]
            elif idx == 1:
                out.min_position = elements[0]
            elif idx == 2:
                out.max_position = elements[0]
            elif idx == 3:
                out.start_states = elements
            elif idx == 4:
                out.end_states = elements
            else:
                out.valid_state_transitions.add((elements[0], elements[1]))
        return out

    def to_text(self) -> str:
        lines = [
            f"{self.max_length}",
            f"{self.min_position}",
            f"{self.max_position}",
            "".join(f"{s} " for s in self.start_states),
            "".join(f"{e} " for e in self.end_states),
        ]
        for cur, nxt in sorted(self.valid_state_transitions):
            lines.append(f"{cur} {nxt}")
        return "\n".join(lines) + "\n"


@dataclass
class RegexDefs:
    """An allstr regex paired with its substring regexes (defs.rs:17-22)."""

    allstr: AllstrRegexDef = field(default_factory=AllstrRegexDef)
    substrs: List[SubstrRegexDef] = field(default_factory=list)
    # Opt-in extension (NOT part of the reference text format, which holds
    # exactly one accepted state, defs.rs:31-33): the full accepting-state
    # set. A final part with an optional tail like `(x)?` yields several
    # accepting DFA states; the reference silently rejects all but the
    # first. None = single-accept reference semantics.
    accept_states: Optional[List[int]] = None

    @property
    def accept_set(self) -> List[int]:
        if self.accept_states is not None:
            return list(self.accept_states)
        if self.allstr.accept_states_ext is not None:
            return list(self.allstr.accept_states_ext)
        return [self.allstr.accepted_state_val]

    @property
    def dummy_state_val(self) -> int:
        """Dummy state used for padded rows (table.rs:67)."""
        return self.allstr.largest_state_val + 1
