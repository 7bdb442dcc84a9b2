"""Thompson NFA construction.

Re-implements the reference's `regexToNfa` (src/vrm/regex.js:375-435)
structurally — the exact ε-edge topology matters because the downstream
subset construction's state-discovery order (and therefore the final state
numbering of the minimized DFA) depends on it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .parser import Node, parse_regex

EPS = "ϵ"


class NfaNode:
    """An NFA node: ``type`` in {start, accept, ""}; ``edges`` is an ordered
    list of (symbol, target) with symbol a single char or ε."""

    __slots__ = ("type", "edges", "id")

    def __init__(self, type_: str = "", edges: Optional[List[Tuple[str, "NfaNode"]]] = None):
        self.type = type_
        self.edges: List[Tuple[str, NfaNode]] = edges if edges is not None else []
        self.id: Optional[int] = None


def _generate_graph(node: Node, start: NfaNode, end: NfaNode, count: int) -> int:
    """Faithful translation of generateGraph (regex.js:377-426)."""
    if start.id is None:
        start.id = count
        count += 1
    t = node.type
    if t == "empty":
        start.edges.append((EPS, end))
    elif t == "text":
        start.edges.append((node.text, end))
    elif t == "cat":
        last = start
        for part in node.parts[:-1]:
            temp = NfaNode()
            count = _generate_graph(part, last, temp, count)
            last = temp
        count = _generate_graph(node.parts[-1], last, end, count)
    elif t == "or":
        for part in node.parts:
            temp_start = NfaNode()
            temp_end = NfaNode(edges=[(EPS, end)])
            start.edges.append((EPS, temp_start))
            count = _generate_graph(part, temp_start, temp_end, count)
    elif t == "star":
        temp_start = NfaNode()
        temp_end = NfaNode(edges=[(EPS, temp_start), (EPS, end)])
        start.edges.append((EPS, temp_start))
        start.edges.append((EPS, end))
        count = _generate_graph(node.sub, temp_start, temp_end, count)
    else:  # pragma: no cover - parser only emits the five node types
        raise ValueError(f"unknown AST node type: {t}")
    if end.id is None:
        end.id = count
        count += 1
    return count


def regex_to_nfa(text: str) -> NfaNode:
    """Build the Thompson NFA for ``text``; returns the start node
    (regex.js:427-434)."""
    ast = parse_regex(text)
    start = NfaNode("start")
    accept = NfaNode("accept")
    _generate_graph(ast, start, accept, 0)
    return start
