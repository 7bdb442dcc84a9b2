"""Decomposed-regex configuration and substring-transition extraction.

Re-implements the reference's VRM pipeline (src/vrm/mod.rs:32-600):

  - :class:`DecomposedRegexConfig` mirrors the JSON config schema
    (mod.rs:32-59);
  - :meth:`DecomposedRegexConfig.extract_substr_ids` reproduces the
    reversed-graph simple-path enumeration, the cumulative fancy-regex
    replay with the empty-match end-index bump, and the
    self-loop/back-edge closure rules (mod.rs:309-600);
  - :meth:`DecomposedRegexConfig.gen_regex_files` writes the allstr/substr
    text tables byte-identically to the reference (mod.rs:67-307).

The reversed graph of the reference (js_caller.rs:86-125, petgraph) is
represented as ``rev_adj[frm][to] = key_str`` — an edge frm->to in the
reversed graph corresponds to the original DFA transition to->frm whose
merged char-group string is ``key_str`` (chars in JSON-array order, i.e.
sorted). The minimized DFA has at most one edge per ordered state pair, so
a dict suffices.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .dfa import MinDfaNode, regex_to_dfa
from .format import format_regex_printable
from .pipeline import (
    dfa_to_regex_def_text,
    edge_key_chars,
    get_accepted_state,
    get_max_state,
    sorted_edge_items,
)


class VrmError(ValueError):
    """Errors in the VRM pipeline (mirrors vrm/mod.rs:19-28)."""


@dataclass
class RegexPartConfig:
    """One decomposed regex part (mod.rs:40-50)."""

    is_public: bool
    regex_def: str
    max_size: int
    solidity: Optional[dict] = None

    @classmethod
    def from_json(cls, obj: dict) -> "RegexPartConfig":
        return cls(
            is_public=obj["is_public"],
            regex_def=obj["regex_def"],
            max_size=obj["max_size"],
            solidity=obj.get("solidity"),
        )


def build_reversed_graph(
    nodes: List[MinDfaNode],
) -> Tuple[Dict[int, Dict[int, str]], Dict[int, int]]:
    """Reversed adjacency + self-loop first-byte map (js_caller.rs:86-125,
    mod.rs:354-370). Returns ``(rev_adj, self_char)`` where
    ``rev_adj[frm][to]`` is the merged char string of the original DFA edge
    to->frm, and ``self_char[v]`` is the first byte of v's self-loop group."""
    rev_adj: Dict[int, Dict[int, str]] = {}
    for i, node in enumerate(nodes):
        for key, nxt in sorted_edge_items(node.edges):
            key_str = "".join(edge_key_chars(key))
            rev_adj.setdefault(nxt, {})[i] = key_str
    self_char: Dict[int, int] = {}
    for v, outs in rev_adj.items():
        if v in outs:
            self_char[v] = ord(outs[v][0])
    return rev_adj, self_char


def enumerate_reverse_paths(
    rev_adj: Dict[int, Dict[int, str]], accepted_state: int
) -> Tuple[List[List[int]], Set[int]]:
    """All simple paths in the reversed graph from the accepted state back to
    any direct successor of state 0, excluding self-loops (the reference
    removes them lazily during the DFS, mod.rs:372-389). Paths are recorded
    accepted-first WITHOUT the trailing 0. Also returns ``self_nodes``: every
    DFS-visited node that carries a self-loop."""
    pathes: List[List[int]] = []
    stack: List[Tuple[int, List[int]]] = [(accepted_state, [accepted_state])]
    self_nodes: Set[int] = set()
    while stack:
        node, path = stack.pop()
        for parent in rev_adj.get(node, {}):
            if parent == node:
                self_nodes.add(node)
                continue
            if parent not in path:
                if parent == 0:
                    pathes.append(list(path))
                    continue
                stack.append((parent, path + [parent]))
    return pathes, self_nodes


@dataclass
class DecomposedRegexConfig:
    """A configuration of decomposed regexes (mod.rs:32-37)."""

    max_byte_size: int
    parts: List[RegexPartConfig] = field(default_factory=list)

    @classmethod
    def from_json(cls, obj: dict) -> "DecomposedRegexConfig":
        return cls(
            max_byte_size=obj["max_byte_size"],
            parts=[RegexPartConfig.from_json(p) for p in obj["parts"]],
        )

    @classmethod
    def from_json_str(cls, s: str) -> "DecomposedRegexConfig":
        return cls.from_json(json.loads(s))

    @classmethod
    def from_json_file(cls, path) -> "DecomposedRegexConfig":
        with open(path) as f:
            return cls.from_json(json.load(f))

    # ------------------------------------------------------------------
    def all_regex(self) -> str:
        """Concatenation of all part regexes (mod.rs:85-89)."""
        return "".join(p.regex_def for p in self.parts)

    def compile_dfa(self) -> List[MinDfaNode]:
        return regex_to_dfa(self.all_regex())

    def part_regex_patterns(self) -> List[str]:
        """Cumulative formatted part regex pattern strings
        (mod.rs:391-405): pattern[i] = pattern[i-1] + format(parts[i])."""
        patterns: List[str] = []
        for i, part in enumerate(self.parts):
            formatted = format_regex_printable(part.regex_def)
            patterns.append(formatted if i == 0 else patterns[i - 1] + formatted)
        return patterns

    def public_part_indexes(self) -> List[int]:
        return [i for i, p in enumerate(self.parts) if p.is_public]

    # ------------------------------------------------------------------
    def extract_substr_ids(
        self, nodes: Optional[List[MinDfaNode]] = None
    ) -> Tuple[
        List[Set[Tuple[int, int]]],
        List[Tuple[Set[int], Set[int]]],
        List[int],
    ]:
        """Per public part: the valid (cur, next) transition set and the
        (start_states, end_states) endpoint sets (mod.rs:309-537)."""
        if nodes is None:
            nodes = self.compile_dfa()
        rev_adj, self_char = build_reversed_graph(nodes)
        accepted_state = get_accepted_state(nodes)
        if accepted_state is None:
            raise VrmError("No accepted state")
        pathes, self_nodes = enumerate_reverse_paths(rev_adj, accepted_state)

        public_config_indexes = self.public_part_indexes()
        part_patterns = self.part_regex_patterns()
        try:
            part_regexes = [re.compile(p) for p in part_patterns]
        except re.error as e:
            # Same limitation as the reference (vrm/mod.rs:398-403 wraps
            # fancy-regex errors): the toy grammar treats `[` `]` as
            # literals, but the substring-replay engine does not — a bare
            # bracket outside an alternation member breaks the replay in
            # both implementations.
            raise VrmError(
                f"substring-replay regex failed to compile ({e}); bare "
                "[ or ] outside an alternation (|[|) is not supported by "
                "the replay engine — same limitation as the reference"
            ) from e

        n_public = len(public_config_indexes)
        substr_defs_array: List[Set[Tuple[int, int]]] = [set() for _ in range(n_public)]
        substr_endpoints_array: List[Tuple[Set[int], Set[int]]] = [
            (set(), set()) for _ in range(n_public)
        ]

        for path in pathes:
            # path: [accepted, ..., child-of-0]; append 0 then reverse to the
            # forward order [0, ..., accepted] (mod.rs:414-437).
            full = path + [0]
            n = len(full) - 1
            edge_strs: List[str] = []
            for idx in range(n):
                frm, to = full[idx], full[idx + 1]
                key_str = rev_adj.get(frm, {}).get(to)
                if key_str is None:
                    raise VrmError(f"No edge from {frm} to {to} in the graph")
                edge_strs.append(key_str)
            path_states = list(reversed(full))
            path_strs = list(reversed(edge_strs))

            substr_states = self._get_substr_defs_from_path(
                path_states, path_strs, part_regexes, public_config_indexes
            )
            for substr_idx, (slice_states, substr) in enumerate(substr_states):
                defs = substr_defs_array[substr_idx]
                starts, ends = substr_endpoints_array[substr_idx]
                starts.add(slice_states[0])
                ends.add(slice_states[-1])
                for j in range(len(slice_states) - 1):
                    defs.add((slice_states[j], slice_states[j + 1]))
                    if slice_states[j] in self_nodes:
                        defs.add((slice_states[j], slice_states[j]))
                    # Back-edges: original DFA edge slice[j+1] -> slice[pre]
                    # (a reversed-graph edge slice[pre] -> slice[j+1],
                    # mod.rs:471-481).
                    for pre in range(j + 1):
                        if slice_states[j + 1] in rev_adj.get(slice_states[pre], {}) and (
                            slice_states[pre] != slice_states[j + 1]
                        ):
                            defs.add((slice_states[j + 1], slice_states[pre]))
                # Trailing self-loop kept only if extending the matched string
                # still satisfies the part regex (mod.rs:485-496).
                last = slice_states[-1]
                if last in self_nodes:
                    part_index = public_config_indexes[substr_idx]
                    extended = substr + chr(self_char[last])
                    if part_regexes[part_index].search(extended) is not None:
                        defs.add((last, last))

        return substr_defs_array, substr_endpoints_array, public_config_indexes

    def _get_substr_defs_from_path(
        self,
        path_states: Sequence[int],
        path_strs: Sequence[str],
        part_regexes: Sequence[re.Pattern],
        public_config_indexes: Sequence[int],
    ) -> List[Tuple[List[int], str]]:
        """Replay the path string against the cumulative part regexes and
        slice out each public part's state run (mod.rs:539-600)."""
        assert len(path_states) == len(path_strs) + 1
        concat_str = "".join(s[0] for s in path_strs)
        index_ends: List[int] = []
        for regex in part_regexes:
            m = regex.search(concat_str)
            if m is None:
                raise VrmError(
                    f"part regex {regex.pattern!r} does not match path string "
                    f"{concat_str!r}"
                )
            # Empty-match end-index bump (mod.rs:577-583).
            index_ends.append(m.end() + 1 if m.start() == m.end() else m.end())
        results: List[Tuple[List[int], str]] = []
        for index in public_config_indexes:
            start = 0 if index == 0 else index_ends[index - 1]
            end = index_ends[index]
            results.append((list(path_states[start : end + 1]), concat_str[:end]))
        return results

    # ------------------------------------------------------------------
    def warn_if_multi_accept(self, nodes=None) -> Optional[str]:
        """The table format supports ONE accepted state (defs.rs:31-33);
        a DFA with several (e.g. a final part ending in `(x)?`) silently
        rejects inputs that land on the unrecorded ones. Returns a warning
        string, or None."""
        if nodes is None:
            nodes = self.compile_dfa()
        accepts = [i for i, n in enumerate(nodes) if n.type == "accept"]
        if len(accepts) > 1:
            return (
                f"DFA has {len(accepts)} accepting states {accepts}; only the "
                f"first ({accepts[0]}) is recorded in the table format — "
                "inputs reaching the others will be rejected. Avoid optional "
                "tails in the final part."
            )
        return None

    def _render_substr_texts(self, nodes) -> List[str]:
        """Format one substr table per public part, byte-identically to the
        reference writer (mod.rs:266-304): max_size / 0 / max-1 /
        sorted starts / sorted ends / sorted (cur, next) pairs."""
        (
            substr_defs_array,
            substr_endpoints_array,
            public_config_indexes,
        ) = self.extract_substr_ids(nodes)
        out = []
        for idx, defs in enumerate(substr_defs_array):
            max_size = self.parts[public_config_indexes[idx]].max_size
            lines = [f"{max_size}\n", f"0\n{self.max_byte_size - 1}\n"]
            starts, ends = substr_endpoints_array[idx]
            lines.append("".join(f"{s} " for s in sorted(starts)) + "\n")
            lines.append("".join(f"{e} " for e in sorted(ends)) + "\n")
            for cur, nxt in sorted(defs):
                lines.append(f"{cur} {nxt}\n")
            out.append("".join(lines))
        return out

    def gen_regex_files(
        self, allstr_file_path, substr_file_pathes, multi_accept: bool = False
    ) -> None:
        """Write the allstr text table and one substr text table per public
        part, byte-identically to the reference (mod.rs:67-307).

        ``multi_accept`` switches line 1 to the opt-in accepting-state-SET
        format extension (no longer reference-byte-identical; readers parse
        both forms)."""
        nodes = self.compile_dfa()
        if not multi_accept:
            warning = self.warn_if_multi_accept(nodes)
            if warning:
                import warnings

                warnings.warn(warning, stacklevel=2)
        Path(allstr_file_path).write_text(
            dfa_to_regex_def_text(nodes, multi_accept=multi_accept)
        )
        for idx, text in enumerate(self._render_substr_texts(nodes)):
            Path(substr_file_pathes[idx]).write_text(text)

    def substr_texts(self) -> List[str]:
        """The substr table file contents as strings (same bytes as
        :meth:`gen_regex_files` writes), for in-memory use."""
        return self._render_substr_texts(self.compile_dfa())
