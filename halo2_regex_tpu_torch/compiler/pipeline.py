"""DFA-JSON helpers and the allstr text-table writer.

Re-implements the pure-Rust DFA-JSON helpers of the reference
(src/vrm/js_caller.rs:57-157): accepted/max state extraction and
``dfa_to_regex_def_text``. The reference parses the DFA JSON with
serde_json, whose default ``Map`` is a BTreeMap — edge keys are therefore
iterated in byte-lexicographic order of the JSON-stringified char-array
key. ``sorted_edge_items`` reproduces that ordering.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .dfa import MinDfaNode, regex_to_dfa


def sorted_edge_items(edges: Dict[str, int]) -> List[Tuple[str, int]]:
    """Edge items in serde_json BTreeMap order: byte-lexicographic on the raw
    JSON key string (js_caller.rs iterates ``val["edges"].as_object()``)."""
    return sorted(edges.items(), key=lambda kv: kv[0])


def edge_key_chars(key: str) -> List[str]:
    """Decode a JSON char-array edge key into its characters, in array order
    (each char asserted length 1, js_caller.rs:117)."""
    chars = json.loads(key)
    for c in chars:
        assert len(c) == 1, f"edge key char {c!r} must have length 1"
    return chars


def get_accepted_state(nodes: List[MinDfaNode]) -> Optional[int]:
    """First node with type "accept" (js_caller.rs:57-64)."""
    for i, n in enumerate(nodes):
        if n.type == "accept":
            return i
    return None


def get_max_state(nodes: List[MinDfaNode]) -> int:
    """Largest TARGET state over all edges (js_caller.rs:66-84). Note the
    reference only scans edge targets, not source indices."""
    max_state = 0
    for n in nodes:
        for _, nxt in n.edges.items():
            if nxt > max_state:
                max_state = nxt
    return max_state


def dfa_to_regex_def_text(nodes: List[MinDfaNode], multi_accept: bool = False) -> str:
    """Serialize the DFA to the allstr text-table format
    (js_caller.rs:127-157):

        line 0: first_state (always 0)
        line 1: accepted_state
        line 2: largest_state
        line 3+: "<cur> <next> <byte>" in (node order, BTreeMap key order,
                 char-within-key order)

    ``multi_accept`` (opt-in format EXTENSION, not byte-compatible with the
    reference): line 1 carries every accepting state, space separated —
    fixing the reference's optional-tail footgun (defs.rs:31-33).
    """
    accepted_state = get_accepted_state(nodes)
    if accepted_state is None:
        raise ValueError("No accepted state")
    max_state = get_max_state(nodes)
    if multi_accept:
        accepts = [i for i, n in enumerate(nodes) if n.type == "accept"]
        line1 = " ".join(str(a) for a in accepts)
    else:
        line1 = str(accepted_state)
    out = ["0", line1, str(max_state)]
    for i, n in enumerate(nodes):
        for key, nxt in sorted_edge_items(n.edges):
            for ch in edge_key_chars(key):
                out.append(f"{i} {nxt} {ord(ch)}")
    return "\n".join(out) + "\n"


def compile_allstr_text(regex: str) -> str:
    """regex string -> allstr text table (the `regexToDfa` +
    `dfa_to_regex_def_text` pipeline)."""
    return dfa_to_regex_def_text(regex_to_dfa(regex))
