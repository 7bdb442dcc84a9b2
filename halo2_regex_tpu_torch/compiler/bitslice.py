"""Boolean-circuit synthesis for the bit-sliced (bitplane) scan backend.

The round-2 performance design packs 32 strings per int32 lane and
evaluates the whole witness pipeline as bitwise boolean ops on "planes"
(one int32 array where bit ``i`` of word ``w`` belongs to string
``w*32 + i``).  This module compiles a :class:`CompiledRegexModel` into
straight-line boolean programs:

  - **class circuit**: 8 byte-bit planes -> one indicator plane per byte
    equivalence class (bytes with identical transition rows).  Synthesized
    as a hash-consed BDD (Shannon decomposition, MSB first) so all class
    functions share sub-expressions.
  - **step circuit**: k class planes + one-hot state planes -> next one-hot
    state planes + log2-encoded state planes.  This is the only circuit on
    the sequential critical path; ops are minimized by grouping states by
    target per class, memoizing unions on their state *set*, and using the
    one-hot invariant (OR of all indicators == 1) to complement large
    unions.
  - **tag circuit**: prev/next log-encoded state planes -> substr-id bit
    planes + is_start/is_end planes (pure function of the (prev, next)
    pair, reference src/lib.rs:825-888).

The programs are backend-agnostic straight-line op lists.  They run on
numpy arrays (verification) or torch tensors (the plain versions of the
kernels, on any device) through :meth:`Program.run`, and are emitted as
straight-line CUDA C by :meth:`Program.to_c` for the hand-written kernels
(``ops/kernels.py``).  This is the PyTorch port's copy of
``halo2_regex_tpu.compiler.bitslice``: synthesis is identical (the tests
compare the instruction lists), only ``run`` and ``to_c`` differ.

Reference behavior being compiled: the per-byte DFA scan and tagging of
src/lib.rs:804-888; the byte->class collapse mirrors the observation that
a DFA's 256 byte rows fall into few equivalence classes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Expression DAG with hash-consing
# ---------------------------------------------------------------------------

_FALSE = ("const", 0)
_TRUE = ("const", 1)


class Builder:
    """Hash-consed AND/OR/NOT DAG over named input variables.

    Nodes are integers (indices into ``self.nodes``); each node is a tuple
    ``("var", name) | ("const", 0|1) | ("not", a) | ("and", a, b) |
    ("or", a, b) | ("xor", a, b)`` with a < b normalization for the
    commutative ops.
    """

    def __init__(self) -> None:
        self.nodes: List[tuple] = []
        self._memo: Dict[tuple, int] = {}
        self.FALSE = self._mk(_FALSE)
        self.TRUE = self._mk(_TRUE)

    def _mk(self, key: tuple) -> int:
        idx = self._memo.get(key)
        if idx is None:
            idx = len(self.nodes)
            self.nodes.append(key)
            self._memo[key] = idx
        return idx

    def var(self, name: str) -> int:
        return self._mk(("var", name))

    def not_(self, a: int) -> int:
        if a == self.FALSE:
            return self.TRUE
        if a == self.TRUE:
            return self.FALSE
        na = self.nodes[a]
        if na[0] == "not":
            return na[1]
        return self._mk(("not", a))

    def and_(self, a: int, b: int) -> int:
        if a == b:
            return a
        if a == self.FALSE or b == self.FALSE:
            return self.FALSE
        if a == self.TRUE:
            return b
        if b == self.TRUE:
            return a
        if self.nodes[a] == ("not", b) or self.nodes[b] == ("not", a):
            return self.FALSE
        if a > b:
            a, b = b, a
        return self._mk(("and", a, b))

    def or_(self, a: int, b: int) -> int:
        if a == b:
            return a
        if a == self.TRUE or b == self.TRUE:
            return self.TRUE
        if a == self.FALSE:
            return b
        if b == self.FALSE:
            return a
        if self.nodes[a] == ("not", b) or self.nodes[b] == ("not", a):
            return self.TRUE
        if a > b:
            a, b = b, a
        return self._mk(("or", a, b))

    def xor_(self, a: int, b: int) -> int:
        if a == b:
            return self.FALSE
        if a == self.FALSE:
            return b
        if b == self.FALSE:
            return a
        if a == self.TRUE:
            return self.not_(b)
        if b == self.TRUE:
            return self.not_(a)
        if a > b:
            a, b = b, a
        return self._mk(("xor", a, b))

    def or_tree(self, xs: Sequence[int]) -> int:
        """Balanced OR reduction (keeps dependency depth logarithmic)."""
        xs = list(xs)
        if not xs:
            return self.FALSE
        while len(xs) > 1:
            nxt = []
            for i in range(0, len(xs) - 1, 2):
                nxt.append(self.or_(xs[i], xs[i + 1]))
            if len(xs) % 2:
                nxt.append(xs[-1])
            xs = nxt
        return xs[0]

    def mux(self, sel: int, hi: int, lo: int) -> int:
        """sel ? hi : lo."""
        if hi == lo:
            return hi
        if hi == self.TRUE and lo == self.FALSE:
            return sel
        if hi == self.FALSE and lo == self.TRUE:
            return self.not_(sel)
        if lo == self.FALSE:
            return self.and_(sel, hi)
        if hi == self.FALSE:
            return self.and_(self.not_(sel), lo)
        if lo == self.TRUE:
            return self.or_(self.not_(sel), hi)
        if hi == self.TRUE:
            return self.or_(sel, lo)
        return self.or_(self.and_(sel, hi), self.and_(self.not_(sel), lo))


# ---------------------------------------------------------------------------
# Straight-line program
# ---------------------------------------------------------------------------


@dataclass
class Program:
    """Topologically ordered op list over a register file.

    ``instrs``: (op, dst, a, b) with op in {not, and, or, xor, const0,
    const1, copy}; ``inputs``: var name -> register; ``outputs``: output
    name -> register; ``n_regs`` total registers.
    """

    instrs: List[Tuple[str, int, int, int]]
    inputs: Dict[str, int]
    outputs: Dict[str, int]
    n_regs: int

    @property
    def n_ops(self) -> int:
        return sum(1 for op, *_ in self.instrs if op not in ("copy",))

    def run(self, env: Dict[str, object]) -> Dict[str, object]:
        """Execute with arbitrary operand objects supporting &, |, ^, ~.

        ``env`` maps input names to operands (numpy bool/int arrays or
        torch tensors).  Constants are built like the sample operand, on
        its device, so torch operands give torch outputs.
        """
        sample = next(iter(env.values()))
        lib = torch if isinstance(sample, torch.Tensor) else np
        c0 = lambda: lib.zeros_like(sample)
        if sample.dtype == (torch.bool if lib is torch else np.bool_):
            c1 = lambda: lib.ones_like(sample)
        else:
            c1 = lambda: lib.full_like(sample, -1)

        regs: List[object] = [None] * self.n_regs
        for name, r in self.inputs.items():
            regs[r] = env[name]
        for op, dst, a, b in self.instrs:
            if op == "and":
                regs[dst] = regs[a] & regs[b]
            elif op == "or":
                regs[dst] = regs[a] | regs[b]
            elif op == "xor":
                regs[dst] = regs[a] ^ regs[b]
            elif op == "not":
                regs[dst] = ~regs[a]
            elif op == "const0":
                regs[dst] = c0()
            elif op == "const1":
                regs[dst] = c1()
            elif op == "copy":
                regs[dst] = regs[a]
        return {name: regs[r] for name, r in self.outputs.items()}

    def to_c(
        self,
        inputs: Dict[str, str],
        outputs: Dict[str, str],
        prefix: str = "r",
    ) -> List[str]:
        """Straight-line CUDA C for this program on ``uint32_t`` words.

        ``inputs`` maps each program input name to a C rvalue, ``outputs``
        each output name to a C lvalue.  Every register becomes a local
        ``const uint32_t {prefix}{i}``, so nvcc allocates them freely.
        All inputs are read before any output is written, so an output
        lvalue may alias an input (in-place state update).
        """
        lines = []
        for name, r in sorted(self.inputs.items(), key=lambda kv: kv[1]):
            lines.append(f"const uint32_t {prefix}{r} = {inputs[name]};")
        for op, dst, a, b in self.instrs:
            ra, rb = f"{prefix}{a}", f"{prefix}{b}"
            if op == "and":
                expr = f"{ra} & {rb}"
            elif op == "or":
                expr = f"{ra} | {rb}"
            elif op == "xor":
                expr = f"{ra} ^ {rb}"
            elif op == "not":
                expr = f"~{ra}"
            elif op == "const0":
                expr = "0u"
            elif op == "const1":
                expr = "0xFFFFFFFFu"
            elif op == "copy":
                expr = ra
            else:
                raise ValueError(f"unknown op {op!r}")
            lines.append(f"const uint32_t {prefix}{dst} = {expr};")
        for name, r in self.outputs.items():
            lines.append(f"{outputs[name]} = {prefix}{r};")
        return lines


def linearize(builder: Builder, outputs: Dict[str, int]) -> Program:
    """Emit the reachable sub-DAG as a straight-line program."""
    needed: List[int] = []
    seen = set()

    def visit(n: int) -> None:
        if n in seen:
            return
        seen.add(n)
        node = builder.nodes[n]
        if node[0] in ("not",):
            visit(node[1])
        elif node[0] in ("and", "or", "xor"):
            visit(node[1])
            visit(node[2])
        needed.append(n)

    for n in outputs.values():
        visit(n)

    reg_of: Dict[int, int] = {}
    instrs: List[Tuple[str, int, int, int]] = []
    inputs: Dict[str, int] = {}
    for n in needed:
        node = builder.nodes[n]
        r = len(reg_of)
        reg_of[n] = r
        if node[0] == "var":
            inputs[node[1]] = r
        elif node[0] == "const":
            instrs.append(("const1" if node[1] else "const0", r, 0, 0))
        elif node[0] == "not":
            instrs.append(("not", r, reg_of[node[1]], 0))
        else:
            instrs.append((node[0], r, reg_of[node[1]], reg_of[node[2]]))
    out = {name: reg_of[n] for name, n in outputs.items()}
    return Program(instrs=instrs, inputs=inputs, outputs=out, n_regs=len(reg_of))


# ---------------------------------------------------------------------------
# Byte-set -> expression over the 8 byte-bit planes (BDD / Shannon)
# ---------------------------------------------------------------------------


def byte_set_expr(
    b: Builder,
    byte_values: Sequence[int],
    prefix: str = "byte_bit",
    n_bits: int = 8,
) -> int:
    """Expression over vars ``{prefix}{n_bits-1..0}`` true iff the value is
    in the set.  Hash-consed Shannon decomposition, MSB first — ASCII
    ranges collapse to short range-comparator DAGs shared across classes.
    (Also used over binary-encoded class-code planes with ``n_bits`` <
    8; Builder-level hash-consing shares sub-products across calls.)"""
    memo: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def rec(level: int, values: Tuple[int, ...]) -> int:
        # level = number of remaining low bits; values are within [0, 2^level)
        if not values:
            return b.FALSE
        if len(values) == 1 << level:
            return b.TRUE
        key = (level, values)
        got = memo.get(key)
        if got is not None:
            return got
        half = 1 << (level - 1)
        lo = tuple(v for v in values if v < half)
        hi = tuple(v - half for v in values if v >= half)
        e = b.mux(
            b.var(f"{prefix}{level - 1}"), rec(level - 1, hi), rec(level - 1, lo)
        )
        memo[key] = e
        return e

    return rec(n_bits, tuple(sorted(set(int(v) for v in byte_values))))


def value_eq_expr(b: Builder, value: int, n_bits: int, prefix: str) -> int:
    """AND of bit literals: true iff the ``n_bits`` planes ``{prefix}{j}``
    encode ``value``."""
    e = b.TRUE
    for j in range(n_bits):
        v = b.var(f"{prefix}{j}")
        e = b.and_(e, v if (value >> j) & 1 else b.not_(v))
    return e


# ---------------------------------------------------------------------------
# Per-def synthesis
# ---------------------------------------------------------------------------


@dataclass
class DefCircuits:
    """Compiled circuits and metadata for one regex def."""

    k: int  # number of byte classes
    class_of: np.ndarray  # [256] int32 byte -> class
    live_states: List[int]  # reachable states (incl. DEAD), scan-time support
    sb: int  # bits for log-encoded state values
    class_prog: Program  # byte_bit{0..7} -> cls{0..k-1}
    step_prog: Program  # cls{c}, st{s in live} -> nst{s}, log{j}
    tag_prog: Optional[Program]  # prev{j}, next{j} -> id{j}, is_start, is_end
    idb: int  # bits for substr ids (global)
    first_state: int
    step_ops: int = 0
    tag_ops: int = 0
    fold_class: bool = True  # step_prog inputs are byte_bit{j} (True) or cls{c}
    class_encoding: str = "onehot"  # class-plane layout when fold_class is
    #   False: "onehot" (k planes cls{c}) or "binary" (ceil(log2 k) planes
    #   clsb{j} carrying the class code; the step circuit decodes them via
    #   shared Shannon sub-products)

    @property
    def class_plane_names(self) -> List[str]:
        """Ordered plane names the pack stage emits / the scan env binds
        (empty when the class BDD is folded into the step circuit)."""
        if self.fold_class:
            return []
        if self.class_encoding == "binary":
            cbb = max(1, (self.k - 1).bit_length())
            return [f"clsb{j}" for j in range(cbb)]
        return [f"cls{c}" for c in range(self.k)]


def _union_expr(
    b: Builder,
    states: Sequence[int],
    ind: Dict[int, int],
    all_states: Sequence[int],
    memo: Dict[frozenset, int],
) -> int:
    """OR of indicator planes for a state set, memoized on the set.  Uses
    the one-hot invariant (exactly one indicator is 1) to complement
    sets larger than half the support."""
    key = frozenset(states)
    got = memo.get(key)
    if got is not None:
        return got
    if len(states) > len(all_states) // 2 + 1:
        comp = [s for s in all_states if s not in key]
        e = b.not_(_union_expr(b, comp, ind, all_states, memo))
    else:
        e = b.or_tree([ind[s] for s in sorted(states)])
    memo[key] = e
    return e


def synthesize_def(
    transition: np.ndarray,  # [256, s_pad] int32 next-state (dead-filled)
    first_state: int,
    dead_state: int,
    substr_pairs: Optional[List[Tuple[int, int, int, bool, bool]]] = None,
    idb: int = 0,
    fold_class: bool = True,
    class_encoding: str = "onehot",
) -> DefCircuits:
    """Build all circuits for one def.

    ``substr_pairs``: (cur, next, global_id, is_start, is_end) per valid
    substr transition (the split-mode pair enumeration,
    pair enumeration of the reference's tagging, src/lib.rs:825-888).

    ``fold_class``: build the step circuit directly over the 8 byte-bit
    planes (class BDD inlined, sub-expressions shared with the transition
    terms) — the scan kernel then reads byte planes straight from the pack
    stage with no separate class pass.  When False the step circuit takes
    class planes as inputs (the separate ``class_prog`` computes them).

    ``class_encoding`` (fold_class=False only): "onehot" emits k
    indicator planes ``cls{c}``; "binary" emits ceil(log2 k) code planes
    ``clsb{j}`` — fewer pack->scan planes than even the 8 byte-bit planes,
    with a ~2^cbb-node shared decode added to the step circuit.
    """
    # Reachable state support (scan starts at first; dead always included
    # as the sink for invalid transitions).
    live = {int(first_state), int(dead_state)}
    frontier = [int(first_state)]
    while frontier:
        s = frontier.pop()
        for t in np.unique(transition[:, s]):
            t = int(t)
            if t not in live:
                live.add(t)
                frontier.append(t)
    live_states = sorted(live)

    # Byte classes: bytes with identical next-state rows over live states.
    rows = transition[:, live_states]  # [256, n_live]
    _, class_of = np.unique(rows, axis=0, return_inverse=True)
    class_of = class_of.astype(np.int32)
    k = int(class_of.max()) + 1

    max_state = int(max(live_states))
    sb = max(1, int(max_state).bit_length())

    # ---- class circuit ----
    cbb = max(1, (k - 1).bit_length())
    cb = Builder()
    class_outputs = {}
    if not fold_class and class_encoding == "binary":
        # one plane per code bit: union of the byte sets of all classes
        # whose code has that bit set (a single shared byte-BDD walk)
        for j in range(cbb):
            byte_vals = np.nonzero((class_of >> j) & 1)[0]
            class_outputs[f"clsb{j}"] = byte_set_expr(cb, byte_vals)
    else:
        for c in range(k):
            byte_vals = np.nonzero(class_of == c)[0]
            class_outputs[f"cls{c}"] = byte_set_expr(cb, byte_vals)
    class_prog = linearize(cb, class_outputs)

    # ---- step circuit ----
    sbld = Builder()
    ind = {s: sbld.var(f"st{s}") for s in live_states}
    union_memo: Dict[frozenset, int] = {}
    # class -> target -> set of source states
    next_acc: Dict[int, List[int]] = {s: [] for s in live_states}
    # Cost model: targets whose total union work is huge could be
    # complemented, but the set-memo + one-hot complement inside
    # _union_expr already bounds each union at n_live/2 ops.
    for c in range(k):
        if fold_class:
            cls_v = byte_set_expr(sbld, np.nonzero(class_of == c)[0])
        elif class_encoding == "binary":
            # singleton Shannon decode over the code planes; Builder
            # hash-consing shares the sub-products across all k decodes
            cls_v = byte_set_expr(sbld, [c], prefix="clsb", n_bits=cbb)
        else:
            cls_v = sbld.var(f"cls{c}")
        # representative byte for this class
        rep = int(np.nonzero(class_of == c)[0][0])
        groups: Dict[int, List[int]] = {}
        for s in live_states:
            t = int(transition[rep, s])
            groups.setdefault(t, []).append(s)
        for t, srcs in groups.items():
            u = _union_expr(sbld, srcs, ind, live_states, union_memo)
            next_acc[t].append(sbld.and_(cls_v, u))
    next_ind: Dict[int, int] = {}
    # The most expensive target (most contributing terms) is derived as
    # the NOR of the others via the one-hot invariant.
    costliest = max(next_acc, key=lambda t: len(next_acc[t]))
    for t in live_states:
        if t != costliest:
            next_ind[t] = sbld.or_tree(next_acc[t])
    next_ind[costliest] = sbld.not_(
        sbld.or_tree([next_ind[t] for t in live_states if t != costliest])
    )

    step_outputs = {f"nst{s}": next_ind[s] for s in live_states}
    enc_memo: Dict[frozenset, int] = {}
    for j in range(sb):
        on = [s for s in live_states if (s >> j) & 1]
        step_outputs[f"log{j}"] = _union_expr(
            sbld, on, next_ind, live_states, enc_memo
        )
    step_prog = linearize(sbld, step_outputs)

    # ---- tag circuit ----
    tag_prog = None
    tag_ops = 0
    if substr_pairs is not None:
        tb = Builder()
        live_set = set(live_states)
        pairs = [p for p in substr_pairs if p[0] in live_set and p[1] in live_set]
        id_acc: Dict[int, List[int]] = {}
        start_acc: List[int] = []
        end_acc: List[int] = []
        # Share per-state equality tests across pairs.
        prev_eq: Dict[int, int] = {}
        next_eq: Dict[int, int] = {}
        for a, bb, gid, s_flag, e_flag in pairs:
            if a not in prev_eq:
                prev_eq[a] = value_eq_expr(tb, a, sb, "prev")
            if bb not in next_eq:
                next_eq[bb] = value_eq_expr(tb, bb, sb, "next")
            m = tb.and_(prev_eq[a], next_eq[bb])
            for j in range(max(idb, 1)):
                if (gid >> j) & 1:
                    id_acc.setdefault(j, []).append(m)
            if s_flag:
                start_acc.append(m)
            if e_flag:
                end_acc.append(m)
        tag_outputs = {}
        for j in range(max(idb, 1)):
            tag_outputs[f"id{j}"] = tb.or_tree(id_acc.get(j, []))
        tag_outputs["is_start"] = tb.or_tree(start_acc)
        tag_outputs["is_end"] = tb.or_tree(end_acc)
        tag_prog = linearize(tb, tag_outputs)
        tag_ops = tag_prog.n_ops

    return DefCircuits(
        k=k,
        class_of=class_of,
        live_states=live_states,
        sb=sb,
        class_prog=class_prog,
        step_prog=step_prog,
        tag_prog=tag_prog,
        idb=idb,
        first_state=int(first_state),
        step_ops=step_prog.n_ops,
        tag_ops=tag_ops,
        fold_class=fold_class,
        class_encoding=class_encoding,
    )


# ---------------------------------------------------------------------------
# Exhaustive verification helpers (used by tests and as a build-time check)
# ---------------------------------------------------------------------------


def verify_def_circuits(c: DefCircuits, transition: np.ndarray) -> None:
    """Exhaustively check class/step/tag programs against the dense tables.

    Evaluates the programs on numpy bool vectors covering every (byte) and
    every (class, state) combination; raises AssertionError on mismatch.
    """
    # class circuit over all 256 bytes
    bytes_all = np.arange(256)
    env = {f"byte_bit{j}": ((bytes_all >> j) & 1).astype(bool) for j in range(8)}
    out = c.class_prog.run(env)
    if not c.fold_class and c.class_encoding == "binary":
        cbb = max(1, (c.k - 1).bit_length())
        for j in range(cbb):
            expect = ((c.class_of >> j) & 1).astype(bool)
            got = out[f"clsb{j}"]
            assert (got == expect).all(), f"class circuit mismatch clsb{j}"
    else:
        for cc in range(c.k):
            expect = c.class_of == cc
            got = out[f"cls{cc}"]
            assert (got == expect).all(), f"class circuit mismatch cls{cc}"

    # step circuit over all (byte-or-class, state) pairs
    if c.fold_class:
        byte_idx = np.repeat(np.arange(256), len(c.live_states))
        st_idx = np.tile(np.array(c.live_states), 256)
        env = {
            f"byte_bit{j}": ((byte_idx >> j) & 1).astype(bool) for j in range(8)
        }
        expect_next = transition[byte_idx, st_idx]
    else:
        cls_idx = np.repeat(np.arange(c.k), len(c.live_states))
        st_idx = np.tile(np.array(c.live_states), c.k)
        if c.class_encoding == "binary":
            cbb = max(1, (c.k - 1).bit_length())
            env = {
                f"clsb{j}": ((cls_idx >> j) & 1).astype(bool)
                for j in range(cbb)
            }
        else:
            env = {f"cls{cc}": cls_idx == cc for cc in range(c.k)}
        reps = [int(np.nonzero(c.class_of == cc)[0][0]) for cc in range(c.k)]
        expect_next = transition[np.array(reps)[cls_idx], st_idx]
    env.update({f"st{s}": st_idx == s for s in c.live_states})
    out = c.step_prog.run(env)
    for s in c.live_states:
        got = out[f"nst{s}"]
        assert (got == (expect_next == s)).all(), f"step circuit mismatch nst{s}"
    for j in range(c.sb):
        got = out[f"log{j}"]
        assert (got == (((expect_next >> j) & 1) == 1)).all(), f"log{j} mismatch"
