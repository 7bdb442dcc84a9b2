"""Mini-evaluator for the emitted circom regex circuits.

The reference's only circom test asserts that generation doesn't error
(reference: src/vrm/circom.rs:78-111) — there is no golden file and its
emitter's reveal order is HashSet-nondeterministic (circom.rs:44), so
byte-parity is not well-defined.  Instead this module *executes* the
emitted circuit text: it parses the rigid generated subset of circom
(LessThan/IsEqual/AND/MultiOR components, the one-hot state recurrence,
``is_consecutive``/``is_substr``/``reveal`` arithmetic) and evaluates it
on concrete byte inputs.  tests/test_circom.py compares the evaluation
against an independent forward model of the same DFA semantics — a true
semantic-equivalence check of the generated circuit.
"""

from __future__ import annotations

import re
from typing import Dict, List


class CircomSim:
    """Evaluate a generated ``<template>`` on a byte string.

    Exposes ``states`` (one-hot rows, shape [num_bytes+1][N]), ``out``
    (acceptance) and ``reveals`` (list of per-substr reveal arrays).
    """

    _ASSIGN = re.compile(r"^\s*(.+?)\s*<==\s*(.+?);\s*$")
    _COMP = re.compile(
        r"^\s*(eq|lt|and|multi_or)\[(\d+)\]\[i\]\s*=\s*"
        r"(IsEqual|LessThan|AND|MultiOR)\((.*?)\);\s*$"
    )

    def __init__(self, circom_text: str, msg: bytes, msg_bytes: int):
        if len(msg) > msg_bytes:
            raise ValueError("msg longer than msg_bytes")
        self.text = circom_text
        self.msg_bytes = msg_bytes
        num_bytes = msg_bytes + 1
        self.num_bytes = num_bytes

        n_match = re.search(r"signal states\[num_bytes\+1\]\[(\d+)\];", circom_text)
        if not n_match:
            raise ValueError("no states declaration found")
        N = int(n_match.group(1))
        self.N = N

        # in[] wiring (circom.js:322: in[0] <== 128)
        inp = [0] * num_bytes
        inp[0] = 128
        padded = list(msg) + [0] * (msg_bytes - len(msg))
        for i in range(msg_bytes):
            inp[i + 1] = padded[i]
        self.inp = inp

        self.states = [[0] * N for _ in range(num_bytes + 1)]
        self.states[0][0] = 1
        self.state_changed = [0] * num_bytes

        # split off the main per-i loop body
        lines = circom_text.split("\n")
        try:
            start = next(
                i
                for i, ln in enumerate(lines)
                if ln.strip() == "for (var i = 0; i < num_bytes; i++) {"
            )
        except StopIteration:
            raise ValueError("main state loop not found")
        depth = 0
        body: List[str] = []
        for ln in lines[start:]:
            depth += ln.count("{") - ln.count("}")
            body.append(ln)
            if depth == 0:
                break
        self._run_state_loop(body[1:-1])
        self._run_accept()
        self._run_reveal(lines)

    # ------------------------------------------------------------------
    def _ref(self, expr: str, i: int, comps: Dict[str, dict]):
        expr = expr.strip()
        if expr.isdigit():
            return int(expr)
        m = re.match(r"^(eq|lt|and|multi_or)\[(\d+)\]\[i\]\.out$", expr)
        if m:
            return comps[f"{m.group(1)}{m.group(2)}"]["out"]
        m = re.match(r"^states\[i\]\[(\d+)\]$", expr)
        if m:
            return self.states[i][int(m.group(1))]
        m = re.match(r"^states\[i\+1\]\[(\d+)\]$", expr)
        if m:
            return self.states[i + 1][int(m.group(1))]
        if expr == "in[i]":
            return self.inp[i]
        if expr == "1 - state_changed[i].out":
            # all state_changed[i].in wires precede this line in the
            # generated text; evaluate the MultiOR from what's collected
            return 1 - (1 if any(self._sc_inputs) else 0)
        raise ValueError(f"unhandled expr {expr!r}")

    def _run_state_loop(self, body: List[str]) -> None:
        for i in range(self.num_bytes):
            comps: Dict[str, dict] = {}
            sc_inputs: List[int] = []
            self._sc_inputs = sc_inputs
            for ln in body:
                ln = ln.strip()
                if not ln:
                    continue
                m = self._COMP.match(ln)
                if m:
                    kind, idx = m.group(1), m.group(2)
                    comps[f"{kind}{idx}"] = {"kind": m.group(3), "in": {}, "out": 0}
                    continue
                m = self._ASSIGN.match(ln)
                if not m:
                    if ln.startswith("state_changed[i] = MultiOR"):
                        continue
                    raise ValueError(f"unhandled line {ln!r}")
                dst, src = m.group(1), m.group(2)
                dm = re.match(
                    r"^(eq|lt|and|multi_or)\[(\d+)\]\[i\]\.(?:in\[(\d+)\]|a|b)$",
                    dst,
                )
                if dm:
                    c = comps[f"{dm.group(1)}{dm.group(2)}"]
                    port = dm.group(3)
                    if port is None:
                        port = "a" if dst.endswith(".a") else "b"
                    c["in"][port] = self._ref(src, i, comps)
                    self._maybe_eval(c)
                    continue
                dm = re.match(r"^states\[i\+1\]\[(\d+)\]$", dst)
                if dm:
                    self.states[i + 1][int(dm.group(1))] = self._ref(src, i, comps)
                    continue
                dm = re.match(r"^state_changed\[i\]\.in\[(\d+)\]$", dst)
                if dm:
                    sc_inputs.append(self._ref(src, i, comps))
                    continue
                raise ValueError(f"unhandled dst {dst!r}")
            self.state_changed[i] = 1 if any(sc_inputs) else 0
            # states[i+1][0] assignment uses state_changed — it appears after
            # the in[] wiring lines in the generated text, so it has already
            # been evaluated via _ref's special case.

    @staticmethod
    def _maybe_eval(c: dict) -> None:
        kind, ins = c["kind"], c["in"]
        if kind == "IsEqual" and {"0", "1"} <= ins.keys():
            c["out"] = 1 if ins["0"] == ins["1"] else 0
        elif kind == "LessThan" and {"0", "1"} <= ins.keys():
            c["out"] = 1 if ins["0"] < ins["1"] else 0
        elif kind == "AND" and {"a", "b"} <= ins.keys():
            c["out"] = ins["a"] * ins["b"]
        elif kind == "MultiOR":
            c["out"] = 1 if any(v for v in ins.values()) else 0

    def _run_accept(self) -> None:
        m = re.search(
            r"final_state_result\.in\[i\] <== states\[i\]\[(\d+)\];", self.text
        )
        if not m:
            raise ValueError("acceptance wiring not found")
        self.accept_node = int(m.group(1))
        self.out = (
            1
            if any(self.states[i][self.accept_node] for i in range(self.num_bytes + 1))
            else 0
        )

    def _run_reveal(self, lines: List[str]) -> None:
        """Evaluate is_consecutive + per-substr reveal blocks
        (circom.rs:28-69 semantics)."""
        self.reveals: List[List[int]] = []
        if "is_consecutive" not in self.text:
            return
        mb, nb = self.msg_bytes, self.num_bytes
        cons = [[0, 0] for _ in range(mb + 1)]
        cons[mb][1] = 1
        acc = self.accept_node
        for i in range(mb):
            j = mb - 1 - i
            cons[j][0] = self.states[nb - i][acc] * (1 - cons[j + 1][1]) + cons[
                j + 1
            ][1]
            cons[j][1] = self.state_changed[mb - i] * cons[j][0]

        # per-substr pair lists from the is_substr lines
        idx = 0
        while f"is_substr{idx}" in self.text:
            pairs = re.findall(
                rf"is_substr{idx}\[i\]\[\d+\] <== is_substr{idx}\[i\]\[\d+\] \+ "
                rf"states\[i\+1\]\[(\d+)\] \* states\[i\+2\]\[(\d+)\];",
                self.text,
            )
            reveal = [0] * mb
            for i in range(mb):
                is_sub = sum(
                    self.states[i + 1][int(a)] * self.states[i + 2][int(b)]
                    for a, b in pairs
                )
                reveal[i] = self.inp[i + 1] * (is_sub * cons[i][1])
            self.reveals.append(reveal)
            idx += 1
