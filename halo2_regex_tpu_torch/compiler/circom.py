"""Circom codegen — parity port of the reference's circom pipeline.

Re-implements ``genCircomAllstr`` (reference: src/vrm/circom.js:1-371) and
the substring-revelation appendix of ``gen_circom``
(src/vrm/circom.rs:17-71) as host-side text generation. This is codegen,
not compute (SURVEY §7 step 8) — the emitted circuit text matches the
reference's structure: one-hot state recurrence with LessThan range
compression over the six contiguous ASCII ranges, IsEqual leftovers,
AND/MultiOR combines, the `^`(94)->128 initial-character hack, MultiOR
acceptance, and the is_consecutive + per-substr reveal logic.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Set, Tuple

from .decomposed import DecomposedRegexConfig
from .dfa import MinDfaNode
from .pipeline import get_accepted_state, sorted_edge_items, edge_key_chars

# The six contiguous ASCII ranges compressed into LessThan pairs
# (circom.js:78-83,114-121): (subset, min_exclusive, max_exclusive).
_RANGES: List[Tuple[Set[int], int, int]] = [
    (set(range(48, 58)), 47, 58),  # digits
    (set(range(58, 65)), 57, 65),  # : ; < = > ? @
    (set(range(65, 91)), 64, 91),  # uppercase
    (set(range(91, 97)), 90, 97),  # [ \ ] ^ _ `
    (set(range(97, 123)), 96, 123),  # lowercase
    (set(range(123, 127)), 122, 127),  # { | } ~
]


def gen_circom_allstr(nodes: List[MinDfaNode], template_name: str) -> str:
    """circom.js:1-371 ``genCircomAllstr``."""
    N = len(nodes)
    rev_graph: List[Dict[int, List[int]]] = [dict() for _ in range(N)]
    to_init_graph: List[List[int]] = [[] for _ in range(N)]
    init_going_state = None
    accept_nodes: List[int] = []
    for i in range(N):
        # JS iterates the JSON object's keys; order only affects the emitted
        # wiring order, and serde-independent insertion order here follows
        # the sorted key order of our DFA JSON.
        for key, v in sorted_edge_items(nodes[i].edges):
            codes = [ord(c) for c in edge_key_chars(key)]
            rev_graph[v][i] = codes
            if i == 0:
                if 94 in codes:  # '^' -> 128 init hack (circom.js:20-24)
                    init_going_state = v
                    codes[codes.index(94)] = 128
                for code in codes:
                    if code != 128:
                        to_init_graph[v].append(code)
        if nodes[i].type == "accept":
            accept_nodes.append(i)

    if init_going_state is not None:
        for going_state, cs in enumerate(to_init_graph):
            if not cs:
                continue
            rev_graph[going_state].setdefault(init_going_state, [])
            rev_graph[going_state][init_going_state] = (
                rev_graph[going_state][init_going_state] + cs
            )

    if 0 in accept_nodes:
        raise ValueError("accept node must not be 0")
    if len(accept_nodes) != 1:
        raise ValueError("the size of accept nodes must be one")

    eq_i = lt_i = and_i = multi_or_i = 0
    lines: List[str] = []
    lines.append("\tfor (var i = 0; i < num_bytes; i++) {")
    lines.append(f"\t\tstate_changed[i] = MultiOR({N - 1});")
    for i in range(1, N):
        outputs = []
        for prev_i in rev_graph[i]:
            k = rev_graph[i][prev_i]
            eq_outputs = []
            vals = set(k)
            if not vals:
                continue
            min_maxs: List[List[int]] = []
            for subset, mn, mx in _RANGES:
                if vals and subset <= vals:
                    vals -= subset
                    if not min_maxs:
                        min_maxs.append([mn, mx])
                    else:
                        last = min_maxs[-1]
                        if last[1] - 1 == mn:
                            last[1] = mx
                        else:
                            min_maxs.append([mn, mx])
            for mn, mx in min_maxs:
                lines.append(f"\t\tlt[{lt_i}][i] = LessThan(8);")
                lines.append(f"\t\tlt[{lt_i}][i].in[0] <== {mn};")
                lines.append(f"\t\tlt[{lt_i}][i].in[1] <== in[i];")
                lines.append(f"\t\tlt[{lt_i + 1}][i] = LessThan(8);")
                lines.append(f"\t\tlt[{lt_i + 1}][i].in[0] <== in[i];")
                lines.append(f"\t\tlt[{lt_i + 1}][i].in[1] <== {mx};")
                lines.append(f"\t\tand[{and_i}][i] = AND();")
                lines.append(f"\t\tand[{and_i}][i].a <== lt[{lt_i}][i].out;")
                lines.append(f"\t\tand[{and_i}][i].b <== lt[{lt_i + 1}][i].out;")
                eq_outputs.append(("and", and_i))
                lt_i += 2
                and_i += 1
            # JS Set preserves insertion order = k's order with range-covered
            # codes removed.
            for code in [c for c in dict.fromkeys(k) if c in vals]:
                lines.append(f"\t\teq[{eq_i}][i] = IsEqual();")
                lines.append(f"\t\teq[{eq_i}][i].in[0] <== in[i];")
                lines.append(f"\t\teq[{eq_i}][i].in[1] <== {code};")
                eq_outputs.append(("eq", eq_i))
                eq_i += 1
            lines.append(f"\t\tand[{and_i}][i] = AND();")
            lines.append(f"\t\tand[{and_i}][i].a <== states[i][{prev_i}];")
            if len(eq_outputs) == 1:
                lines.append(
                    f"\t\tand[{and_i}][i].b <== "
                    f"{eq_outputs[0][0]}[{eq_outputs[0][1]}][i].out;"
                )
            elif len(eq_outputs) > 1:
                lines.append(f"\t\tmulti_or[{multi_or_i}][i] = MultiOR({len(eq_outputs)});")
                for oi, (kind, idx) in enumerate(eq_outputs):
                    lines.append(
                        f"\t\tmulti_or[{multi_or_i}][i].in[{oi}] <== {kind}[{idx}][i].out;"
                    )
                lines.append(f"\t\tand[{and_i}][i].b <== multi_or[{multi_or_i}][i].out;")
                multi_or_i += 1
            outputs.append(and_i)
            and_i += 1
        if len(outputs) == 1:
            lines.append(f"\t\tstates[i+1][{i}] <== and[{outputs[0]}][i].out;")
        elif len(outputs) > 1:
            lines.append(f"\t\tmulti_or[{multi_or_i}][i] = MultiOR({len(outputs)});")
            for oi, out in enumerate(outputs):
                lines.append(f"\t\tmulti_or[{multi_or_i}][i].in[{oi}] <== and[{out}][i].out;")
            lines.append(f"\t\tstates[i+1][{i}] <== multi_or[{multi_or_i}][i].out;")
            multi_or_i += 1
        lines.append(f"\t\tstate_changed[i].in[{i - 1}] <== states[i+1][{i}];")
    lines.append("\t\tstates[i+1][0] <== 1 - state_changed[i].out;")
    lines.append("\t}")

    declarations = []
    declarations.append(
        'pragma circom 2.1.5;\ninclude '
        '"@zk-email/circuits/regexes/regex_helpers.circom";\n'
    )
    declarations.append(f"template {template_name}(msg_bytes) {{")
    declarations.append("\tsignal input msg[msg_bytes];")
    declarations.append("\tsignal output out;\n")
    declarations.append("\tvar num_bytes = msg_bytes+1;")
    declarations.append("\tsignal in[num_bytes];")
    declarations.append("\tin[0]<==128;")
    declarations.append("\tfor (var i = 0; i < msg_bytes; i++) {")
    declarations.append("\t\tin[i+1] <== msg[i];")
    declarations.append("\t}\n")
    if eq_i > 0:
        declarations.append(f"\tcomponent eq[{eq_i}][num_bytes];")
    if lt_i > 0:
        declarations.append(f"\tcomponent lt[{lt_i}][num_bytes];")
    if and_i > 0:
        declarations.append(f"\tcomponent and[{and_i}][num_bytes];")
    if multi_or_i > 0:
        declarations.append(f"\tcomponent multi_or[{multi_or_i}][num_bytes];")
    declarations.append(f"\tsignal states[num_bytes+1][{N}];")
    declarations.append("\tcomponent state_changed[num_bytes];")
    declarations.append("")

    init_code = []
    init_code.append("\tstates[0][0] <== 1;")
    init_code.append(f"\tfor (var i = 1; i < {N}; i++) {{")
    init_code.append("\t\tstates[0][i] <== 0;")
    init_code.append("\t}")
    init_code.append("")

    all_lines = declarations + init_code + lines

    accept_node = accept_nodes[0]
    accept_lines = [""]
    accept_lines.append("\tcomponent final_state_result = MultiOR(num_bytes+1);")
    accept_lines.append("\tfor (var i = 0; i <= num_bytes; i++) {")
    accept_lines.append(f"\t\tfinal_state_result.in[i] <== states[i][{accept_node}];")
    accept_lines.append("\t}")
    accept_lines.append("\tout <== final_state_result.out;")
    all_lines = all_lines + accept_lines
    return "".join(line + "\n" for line in all_lines)


def gen_circom(
    config: DecomposedRegexConfig, circom_path, template_name: str
) -> str:
    """circom.rs:17-71: allstr template + substring revelation logic."""
    nodes = config.compile_dfa()
    accepted_state = get_accepted_state(nodes)
    if accepted_state is None:
        raise ValueError("No accepted state")
    circom = gen_circom_allstr(nodes, template_name)
    circom += "\n"
    substr_defs_array, _, _ = config.extract_substr_ids(nodes)
    circom += "\tsignal is_consecutive[msg_bytes+1][2];\n"
    circom += "\tis_consecutive[msg_bytes][1] <== 1;\n"
    circom += "\tfor (var i = 0; i < msg_bytes; i++) {\n"
    circom += (
        f"\t\tis_consecutive[msg_bytes-1-i][0] <== "
        f"states[num_bytes-i][{accepted_state}] * "
        f"(1 - is_consecutive[msg_bytes-i][1]) + is_consecutive[msg_bytes-i][1];\n"
    )
    circom += (
        "\t\tis_consecutive[msg_bytes-1-i][1] <== "
        "state_changed[msg_bytes-i].out * is_consecutive[msg_bytes-1-i][0];\n"
    )
    circom += "\t}\n"

    for idx, defs in enumerate(substr_defs_array):
        num_defs = len(defs)
        circom += f"\tsignal is_substr{idx}[msg_bytes][{num_defs + 1}];\n"
        circom += f"\tsignal is_reveal{idx}[msg_bytes];\n"
        circom += f"\tsignal output reveal{idx}[msg_bytes];\n"
        circom += "\tfor (var i = 0; i < msg_bytes; i++) {\n"
        circom += f"\t\tis_substr{idx}[i][0] <== 0;\n"
        # The reference iterates a HashSet here (nondeterministic order,
        # circom.rs:44); we sort for reproducible output.
        for j, (cur, nxt) in enumerate(sorted(defs)):
            circom += (
                f"\t\tis_substr{idx}[i][{j + 1}] <== is_substr{idx}[i][{j}] + "
            )
            circom += f"states[i+1][{cur}] * states[i+2][{nxt}];\n"
        circom += (
            f"\t\tis_reveal{idx}[i] <== is_substr{idx}[i][{num_defs}] * "
            f"is_consecutive[i][1];\n"
        )
        circom += f"\t\treveal{idx}[i] <== in[i+1] * is_reveal{idx}[i];\n"
        circom += "\t}\n"
    circom += "}"
    if circom_path is not None:
        Path(circom_path).write_text(circom)
    return circom
