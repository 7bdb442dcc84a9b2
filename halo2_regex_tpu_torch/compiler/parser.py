"""Toy regex grammar parser.

Re-implements, in Python, the recursive-descent grammar of the reference's
embedded regex compiler (reference: src/vrm/regex.js:236-367 `parseRegex`).

Supported grammar (deliberately tiny — see reference regex.js:215-234):
  - literal characters (`.` is a LITERAL dot, not a wildcard)
  - grouping `( ... )`
  - alternation `|`
  - `*`, `+` (desugared to ``S S*``), `?` (desugared to ``S | ε``)
  - the literal epsilon character `ϵ`
  - backslash escapes: only ``{n, r, t, v, f}`` map to control characters
    (regex.js:7); any other ``\\c`` yields the literal character ``c``.

No character classes ``[a-z]``, no ``{m,n}`` repetition, no anchors.

The AST node types mirror the reference: ``empty``, ``text``, ``cat``,
``or``, ``star``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

# Escape map of the reference compiler (regex.js:7). Everything else maps to
# the escaped character itself (regex.js:357-359).
ESCAPE_MAP = {"n": "\n", "r": "\r", "t": "\t", "v": "\v", "f": "\f"}


class RegexParseError(ValueError):
    """Raised when the toy grammar fails to parse (mirrors the error strings
    returned by regex.js parseSub)."""


@dataclass
class Node:
    """AST node. ``type`` in {empty, text, cat, or, star}."""

    type: str
    text: Optional[str] = None
    parts: List["Node"] = field(default_factory=list)
    sub: Optional["Node"] = None


@dataclass(frozen=True)
class _Lit:
    """A token produced from a backslash escape: always a literal character,
    never an operator (mirrors the array-wrapping at regex.js:359)."""

    char: str


Token = Union[str, _Lit]


def tokenize(text: str) -> List[Token]:
    """Apply the escape pre-pass of parseRegex (regex.js:353-366)."""
    out: List[Token] = []
    i = 0
    n = len(text)
    while i < n:
        if text[i] == "\\":
            # Note: if the backslash is the last character, JS reads
            # text[i+1] === undefined and pushes [undefined]; we reject it.
            if i + 1 >= n:
                raise RegexParseError("Error: trailing backslash.")
            c = text[i + 1]
            out.append(_Lit(ESCAPE_MAP.get(c, c)))
            i += 2
        else:
            out.append(text[i])
            i += 1
    return out


def _parse_sub(tokens: List[Token], begin: int, end: int, first: bool) -> Node:
    """Faithful translation of parseSub (regex.js:238-351)."""
    if len(tokens) == 0:
        raise RegexParseError(f"Error: empty input at {begin}.")
    parts: List[Node] = []
    if first:
        # Split on top-level '|'.
        last = 0
        stack = 0
        for i in range(len(tokens) + 1):
            tok = tokens[i] if i < len(tokens) else None
            if i == len(tokens) or (tok == "|" and stack == 0):
                if last == 0 and i == len(tokens):
                    return _parse_sub(tokens, begin + last, begin + i, False)
                sub = _parse_sub(tokens[last:i], begin + last, begin + i, True)
                parts.append(sub)
                last = i + 1
            elif tok == "(":
                stack += 1
            elif tok == ")":
                stack -= 1
        if len(parts) == 1:
            return parts[0]
        return Node("or", parts=parts)

    i = 0
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        if tok == "(":
            last = i + 1
            i += 1
            stack = 1
            while i < n and stack != 0:
                if tokens[i] == "(":
                    stack += 1
                elif tokens[i] == ")":
                    stack -= 1
                i += 1
            if stack != 0:
                raise RegexParseError(
                    f"Error: missing right bracket for {begin + last}."
                )
            i -= 1
            sub = _parse_sub(tokens[last:i], begin + last, begin + i, True)
            parts.append(sub)
        elif tok == "*":
            if not parts:
                raise RegexParseError(f"Error: unexpected * at {begin + i}.")
            parts[-1] = Node("star", sub=parts[-1])
        elif tok == "+":
            # S+ -> S S*  (regex.js:306-316). The star's sub SHARES the node.
            if not parts:
                raise RegexParseError(f"Error: unexpected + at {begin + i}.")
            last_node = parts[-1]
            parts[-1] = Node("cat", parts=[last_node, Node("star", sub=last_node)])
        elif tok == "?":
            # S? -> S | ε  (regex.js:317-327).
            if not parts:
                raise RegexParseError(f"Error: unexpected + at {begin + i}.")
            last_node = parts[-1]
            parts[-1] = Node("or", parts=[last_node, Node("empty", sub=last_node)])
        elif tok == "ϵ":
            parts.append(Node("empty"))
        elif isinstance(tok, _Lit):
            parts.append(Node("text", text=tok.char))
        else:
            parts.append(Node("text", text=tok))
        i += 1
    if len(parts) == 1:
        return parts[0]
    return Node("cat", parts=parts)


def parse_regex(text: str) -> Node:
    """Parse a regex of the toy grammar into an AST (regex.js:236-367)."""
    tokens = tokenize(text)
    return _parse_sub(tokens, 0, len(tokens), True)
