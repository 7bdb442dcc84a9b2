"""Regex-string formatting helpers.

Re-implements `formatRegexPrintable`, `catchAllRegexStr`,
`catchAllWithoutRNRegexStr` and `textContextPrefix` from the reference
(src/vrm/regex.js:11-38). ``format_regex_printable`` re-escapes a toy-grammar
regex for a Perl-style backtracking engine; the reference feeds the result to
Rust's fancy-regex (vrm/mod.rs:398-403), we feed it to Python's ``re`` —
both use leftmost-first backtracking semantics, and the tiny feature subset
involved (literals, groups, alternation, ``* + ?``) behaves identically.
"""

from __future__ import annotations

import json


def catch_all_regex_str() -> str:
    """regex.js:11-17 — printable ASCII + whitespace alternation."""
    return (
        "(0|1|2|3|4|5|6|7|8|9|a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p|q|r|s|t|u|v|w|x"
        "|y|z|A|B|C|D|E|F|G|H|I|J|K|L|M|N|O|P|Q|R|S|T|U|V|W|X|Y|Z|!|\"|#|$|%"
        "|&|'|\\(|\\)|\\*|\\+|,|-|.|/|:|;|<|=|>|\\?|@|[|\\\\|]|^|_|`|{|\\||}"
        "|~| |\t|\n|\r|\x0b|\x0c)"
    )


def catch_all_without_rn_regex_str() -> str:
    """regex.js:15-17 — catch-all minus CR/LF."""
    return (
        "(0|1|2|3|4|5|6|7|8|9|a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p|q|r|s|t|u|v|w|x"
        "|y|z|A|B|C|D|E|F|G|H|I|J|K|L|M|N|O|P|Q|R|S|T|U|V|W|X|Y|Z|!|\"|#|$|%"
        "|&|'|\\(|\\)|\\*|\\+|,|-|.|/|:|;|<|=|>|\\?|@|[|\\\\|]|^|_|`|{|\\||}"
        "|~| |\t|\x0b|\x0c)"
    )


def text_context_prefix() -> str:
    """regex.js:19-21."""
    return 'Content-Type: text/plain; charset="UTF-8"\r\n\r\n'


def format_regex_printable(s: str) -> str:
    """Faithful port of formatRegexPrintable (regex.js:23-38).

    JSON-escapes the string (``JSON.stringify`` ≡ ``json.dumps`` for the
    ASCII inputs involved: identical short escapes \\n \\r \\t \\f \\b,
    identical \\uXXXX fallback, identical quote/backslash escaping), strips
    the quotes, then applies the reference's replacement chain in order.
    Note the \\u000b replacement pattern is the literal VT character, which
    never appears in the JSON-escaped text — a faithful no-op.
    """
    escaped_json = json.dumps(s)
    escaped = escaped_json[1:-1]
    escaped = escaped.replace("\\\\\\\\", "\\")
    escaped = escaped.replace("\\\\", "\\")
    escaped = escaped.replace("/", "\\/")
    escaped = escaped.replace("\x0b", "\\♥")
    escaped = escaped.replace("^", "\\^")
    escaped = escaped.replace("$", "\\$")
    escaped = escaped.replace("|[|", "|\\[|")
    escaped = escaped.replace("|]|", "|\\]|")
    escaped = escaped.replace("|.|", "|\\.|")
    escaped = escaped.replace("|$|", "|\\$|")
    escaped = escaped.replace("|^|", "|\\^|")
    return escaped
