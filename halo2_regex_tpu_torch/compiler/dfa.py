"""Subset construction + Hopcroft minimization + canonical renumbering.

Re-implements the reference pipeline `minDfa(nfaToDfa(nfa))` plus the final
BFS/"nature" renumbering of `regexToDfa` (src/vrm/regex.js:443-553,
561-762, 40-90) so that the produced state NUMBERING is identical:

  - subset construction is a FIFO BFS that processes each subset-state's
    symbols in sorted order and labels discovered states "A", "B", ...
    via ``to_alpha_count`` (regex.js:516-526, 527-552);
  - Hopcroft partitions keep their members in the order induced by the
    STRING sort of those alpha labels (regex.js:613, 618-634);
  - partitions are sorted by their comma-joined member keys, then the
    partition containing the initial state is SWAPPED (not rotated) to the
    front (regex.js:698-718);
  - the final state index of a partition is its position in that list
    (regex.js:719-727 assigns id ``i+1``; regexToDfa:72-89 renumbers by
    ``nature - 1``, which is exactly the partition index).

Merged transitions between a pair of minimized states carry the
JSON-stringified sorted char array as their symbol key
(regex.js:746-752), reproduced here with ``json.dumps(..., separators=(",", ":"))``
which matches ``JSON.stringify`` byte-for-byte for the ASCII alphabets
involved.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .nfa import EPS, NfaNode, regex_to_nfa


def to_alpha_count(n: int) -> str:
    """Bijective base-26 label: 0->A, 25->Z, 26->AA ... (regex.js:516-526)."""
    s = ""
    while n >= 0:
        s = chr(n % 26 + ord("A")) + s
        n = n // 26 - 1
    return s


class DfaState:
    """A subset-construction state (pre-minimization)."""

    __slots__ = ("members", "symbols", "type", "trans", "id")

    def __init__(self, members: frozenset, symbols: List[str], type_: str):
        self.members = members  # frozenset of NFA node ids
        self.symbols = symbols
        self.type = type_
        self.trans: Dict[str, "DfaState"] = {}
        self.id: str = ""


class _NfaIndex:
    """Precomputed per-node ε-closures and symbol moves over the NFA.

    The reference recomputes closures from scratch for every (state, symbol)
    pair (regex.js:445-515); the resulting SETS are identical, so this index
    changes nothing observable — closure membership, per-subset symbol sets
    and accept typing all agree with the direct walk (every closure member's
    edges are scanned by the JS walk, including the seed nodes)."""

    def __init__(self, nfa: NfaNode):
        # Collect all reachable nodes; node.id (assigned by generateGraph) is
        # the numeric identity used for subset keys in the reference.
        nodes: Dict[int, NfaNode] = {}
        stack = [nfa]
        while stack:
            nd = stack.pop()
            if nd.id in nodes:
                continue
            nodes[nd.id] = nd
            for _, tgt in nd.edges:
                if tgt.id not in nodes:
                    stack.append(tgt)
        self.nodes = nodes
        self.accept_ids = frozenset(i for i, nd in nodes.items() if nd.type == "accept")
        # Per-node non-ε moves and ε adjacency.
        self.moves: Dict[int, Dict[str, Tuple[int, ...]]] = {}
        eps_adj: Dict[int, List[int]] = {}
        for i, nd in nodes.items():
            mv: Dict[str, List[int]] = {}
            eps: List[int] = []
            for sym, tgt in nd.edges:
                if sym == EPS:
                    eps.append(tgt.id)
                else:
                    mv.setdefault(sym, []).append(tgt.id)
            self.moves[i] = {s: tuple(ts) for s, ts in mv.items()}
            eps_adj[i] = eps
        # ε-closure per node via iterative DFS with memoization on the SCC
        # condensation (ε-cycles from star loops share one closure).
        self.closure: Dict[int, frozenset] = {}
        self._compute_closures(eps_adj)

    def _compute_closures(self, eps_adj: Dict[int, List[int]]) -> None:
        # Tarjan SCC (iterative).
        index_of: Dict[int, int] = {}
        low: Dict[int, int] = {}
        on_stack: Dict[int, bool] = {}
        scc_of: Dict[int, int] = {}
        sccs: List[List[int]] = []
        counter = [0]
        stack_s: List[int] = []
        for root in eps_adj:
            if root in index_of:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index_of[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack_s.append(v)
                    on_stack[v] = True
                recurse = False
                adj = eps_adj[v]
                for j in range(pi, len(adj)):
                    w = adj[j]
                    if w not in index_of:
                        work[-1] = (v, j + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    elif on_stack.get(w):
                        low[v] = min(low[v], index_of[w])
                if recurse:
                    continue
                if low[v] == index_of[v]:
                    comp = []
                    while True:
                        w = stack_s.pop()
                        on_stack[w] = False
                        scc_of[w] = len(sccs)
                        comp.append(w)
                        if w == v:
                            break
                    sccs.append(comp)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
        # SCCs are produced in reverse topological order (successors first),
        # so closures of successor components are ready when needed.
        scc_closure: List[frozenset] = []
        for comp in sccs:
            acc = set(comp)
            for v in comp:
                for w in eps_adj[v]:
                    if scc_of[w] != scc_of[v]:
                        acc |= scc_closure[scc_of[w]]
            scc_closure.append(frozenset(acc))
        for v in eps_adj:
            self.closure[v] = scc_closure[scc_of[v]]

    def closure_of(self, seed_ids) -> frozenset:
        acc: set = set()
        for i in seed_ids:
            acc |= self.closure[i]
        return frozenset(acc)

    def make_state(self, members: frozenset) -> DfaState:
        syms: set = set()
        for m in members:
            syms.update(self.moves[m].keys())
        type_ = "accept" if members & self.accept_ids else ""
        return DfaState(members, sorted(syms), type_)

    def closed_move(self, state: DfaState, symbol: str) -> frozenset:
        seeds: set = set()
        for m in state.members:
            tgts = self.moves[m].get(symbol)
            if tgts:
                seeds.update(tgts)
        return self.closure_of(seeds)


def nfa_to_dfa(nfa: NfaNode) -> DfaState:
    """Subset construction, FIFO BFS over symbols in sorted order, alpha-count
    ids in discovery order (regex.js:527-552)."""
    idx = _NfaIndex(nfa)
    first = idx.make_state(idx.closure_of([nfa.id]))
    count = 0
    first.id = to_alpha_count(count)
    states: Dict[frozenset, DfaState] = {first.members: first}
    queue: List[DfaState] = [first]
    front = 0
    while front < len(queue):
        top = queue[front]
        front += 1
        for sym in top.symbols:
            members = idx.closed_move(top, sym)
            if members not in states:
                count += 1
                st = idx.make_state(members)
                st.id = to_alpha_count(count)
                states[members] = st
                queue.append(st)
            top.trans[sym] = states[members]
    return first


@dataclass
class MinDfaNode:
    """A state of the minimized DFA after canonical renumbering."""

    type: str  # "accept" or ""
    # Merged edges: JSON-stringified sorted char array -> target state index.
    edges: Dict[str, int] = field(default_factory=dict)


def _reverse_edges(
    start: DfaState,
) -> Tuple[List[str], Dict[str, DfaState], Dict[str, Dict[str, List[str]]]]:
    """BFS collecting the alphabet, id->state map, and reverse edge lists
    (regex.js:563-599)."""
    symbols: Dict[str, bool] = {}
    id_map: Dict[str, DfaState] = {}
    rev_edges: Dict[str, Dict[str, List[str]]] = {}
    visited = {start.id}
    queue = [start]
    front = 0
    while front < len(queue):
        top = queue[front]
        front += 1
        id_map[top.id] = top
        for sym in top.symbols:
            symbols.setdefault(sym, True)
            nxt = top.trans[sym]
            rev_edges.setdefault(nxt.id, {}).setdefault(sym, []).append(top.id)
            if nxt.id not in visited:
                visited.add(nxt.id)
                queue.append(nxt)
    return list(symbols.keys()), id_map, rev_edges


def _hopcroft(
    symbols: List[str],
    id_map: Dict[str, DfaState],
    rev_edges: Dict[str, Dict[str, List[str]]],
) -> List[List[str]]:
    """Faithful translation of the reference's Hopcroft refinement
    (regex.js:600-688). Missing transitions follow the implicit-dead-state
    convention (a state with no transition on ``s`` is never in pre(W))."""
    ids = sorted(id_map.keys())  # JS Object.keys(...).sort(): string sort
    partitions: Dict[str, List[str]] = {}
    queue: List[Optional[str]] = []
    visited: Dict[str, int] = {}
    group1 = [i for i in ids if id_map[i].type == "accept"]
    group2 = [i for i in ids if id_map[i].type != "accept"]
    key = ",".join(group1)
    partitions[key] = group1
    queue.append(key)
    visited[key] = 0
    if group2:
        key = ",".join(group2)
        partitions[key] = group2
        queue.append(key)
    front = 0
    while front < len(queue):
        top_key = queue[front]
        front += 1
        if not top_key:
            continue
        top = top_key.split(",")
        for sym in symbols:
            rev_group = set()
            for member in top:
                by_sym = rev_edges.get(member)
                if by_sym and sym in by_sym:
                    rev_group.update(by_sym[sym])
            for key in list(partitions.keys()):
                part = partitions[key]
                g1 = [x for x in part if x in rev_group]
                g2 = [x for x in part if x not in rev_group]
                if g1 and g2:
                    del partitions[key]
                    key1 = ",".join(g1)
                    key2 = ",".join(g2)
                    partitions[key1] = g1
                    partitions[key2] = g2
                    if key1 in visited:
                        queue[visited[key1]] = None
                        visited[key1] = len(queue)
                        queue.append(key1)
                        visited[key2] = len(queue)
                        queue.append(key2)
                    elif len(g1) <= len(g2):
                        visited[key1] = len(queue)
                        queue.append(key1)
                    else:
                        visited[key2] = len(queue)
                        queue.append(key2)
    return list(partitions.values())


def min_dfa(dfa: DfaState) -> List[MinDfaNode]:
    """Minimize and renumber; returns the node list indexed by final state id
    (regex.js:561-762 + the regexToDfa renumbering, regex.js:50-89)."""
    symbols, id_map, rev_edges = _reverse_edges(dfa)
    partitions = _hopcroft(symbols, id_map, rev_edges)

    # buildMinNfa (regex.js:689-755): sort partitions by joined key, swap the
    # start partition to the front.
    partitions.sort(key=lambda p: ",".join(p))
    for i, part in enumerate(partitions):
        if dfa.id in part:
            if i > 0:
                partitions[i], partitions[0] = partitions[0], partitions[i]
            break

    group: Dict[str, int] = {}
    nodes: List[MinDfaNode] = []
    for i, part in enumerate(partitions):
        nodes.append(MinDfaNode(type=id_map[part[0]].type))
        for member in part:
            group[member] = i

    # Merge transitions between partition pairs; the merged symbol is the
    # JSON-stringified sorted char array (regex.js:736-753).
    pair_chars: Dict[Tuple[int, int], set] = {}
    for to_id, by_sym in rev_edges.items():
        for sym, from_ids in by_sym.items():
            for from_id in from_ids:
                pair_chars.setdefault((group[from_id], group[to_id]), set()).add(sym)
    for (frm, to), chars in pair_chars.items():
        key = json.dumps(sorted(chars), separators=(",", ":"))
        nodes[frm].edges[key] = to
    return nodes


_DFA_CACHE: Dict[str, List[MinDfaNode]] = {}


def regex_to_dfa(regex: str) -> List[MinDfaNode]:
    """Full pipeline: parse -> NFA -> DFA -> minimize -> renumber
    (regex.js:40-90 ``regexToDfa``). Results are cached per regex string;
    callers must treat the returned node list as immutable."""
    cached = _DFA_CACHE.get(regex)
    if cached is None:
        cached = min_dfa(nfa_to_dfa(regex_to_nfa(regex)))
        _DFA_CACHE[regex] = cached
    return cached


def dfa_to_json(nodes: List[MinDfaNode]) -> List[dict]:
    """The reference's DFA JSON schema: ``[{"type": ..., "edges": {...}}]``
    with state index = list index (SURVEY §8.2)."""
    return [{"type": n.type, "edges": dict(n.edges)} for n in nodes]
