"""Model zoo — ready-made decomposed-regex configs.

The zk-email-style header models (from/to/subject — BASELINE configs[2])
plus the reference's fixture configs, all expressed in the toy grammar the
compiler supports (no char classes; explicit alternations; `.` literal —
SURVEY §8.1). ``body_prefix`` mirrors the reference's
``textContextPrefix`` (regex.js:19-21).
"""

from __future__ import annotations

from typing import List

from ..compiler.decomposed import DecomposedRegexConfig
from ..compiler.format import catch_all_regex_str, catch_all_without_rn_regex_str

# Alternation helpers -------------------------------------------------------


def alt(chars: str) -> str:
    """Explicit alternation group over a literal character set, escaping the
    toy grammar's operator characters."""
    out = []
    for c in chars:
        if c in "()*+?|\\":
            out.append("\\" + c)
        else:
            out.append(c)
    return "(" + "|".join(out) + ")"


LOWER = alt("abcdefghijklmnopqrstuvwxyz")
UPPER = alt("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
DIGIT = alt("0123456789")
ALNUM = alt(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
)
# RFC-ish atom chars for email local parts / display names, expressed the
# way the reference's fixtures spell them (regex3_test.json).
EMAIL_CHAR = (
    "(a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p|q|r|s|t|u|v|w|x|y|z"
    "|A|B|C|D|E|F|G|H|I|J|K|L|M|N|O|P|Q|R|S|T|U|V|W|X|Y|Z"
    "|0|1|2|3|4|5|6|7|8|9|_|\\.|-)"
)
NAME_CHAR = (
    "(a|b|c|d|e|f|g|h|i|j|k|l|m|n|o|p|q|r|s|t|u|v|w|x|y|z"
    "|A|B|C|D|E|F|G|H|I|J|K|L|M|N|O|P|Q|R|S|T|U|V|W|X|Y|Z"
    "|0|1|2|3|4|5|6|7|8|9|_|\\.|\"| |@)"
)
EMAIL_ADDR = f"{EMAIL_CHAR}+@{EMAIL_CHAR}+"


def _header_config(header: str, max_byte_size: int = 1024) -> dict:
    """An email header matcher: `(anything CRLF)? header: (name<)? ADDR >?CRLF`
    exposing the address — the regex3 fixture shape generalized."""
    ca = catch_all_regex_str()
    return {
        "max_byte_size": max_byte_size,
        "parts": [
            {"is_public": False, "regex_def": f"({ca}+\r\n)?", "max_size": max_byte_size},
            {"is_public": False, "regex_def": f"{header}:", "max_size": len(header) + 2},
            {"is_public": False, "regex_def": f"({NAME_CHAR}+<)?", "max_size": 64},
            {
                "is_public": True,
                "regex_def": EMAIL_ADDR,
                "max_size": 64,
                "solidity": {"type": "String"},
            },
            {"is_public": False, "regex_def": ">?\r\n", "max_size": 3},
        ],
    }


def from_header_config(max_byte_size: int = 1024) -> dict:
    return _header_config("from", max_byte_size)


def to_header_config(max_byte_size: int = 1024) -> dict:
    return _header_config("to", max_byte_size)


def subject_config(max_byte_size: int = 1024) -> dict:
    """Subject header: expose the whole subject line text."""
    ca = catch_all_regex_str()
    no_rn = catch_all_without_rn_regex_str()
    return {
        "max_byte_size": max_byte_size,
        "parts": [
            {"is_public": False, "regex_def": f"({ca}+\r\n)?", "max_size": max_byte_size},
            {"is_public": False, "regex_def": "subject:", "max_size": 9},
            {
                "is_public": True,
                "regex_def": f"{no_rn}+",
                "max_size": 256,
                "solidity": {"type": "String"},
            },
            {"is_public": False, "regex_def": "\r\n", "max_size": 2},
        ],
    }


def body_prefix_config(max_byte_size: int = 1024) -> dict:
    """The reference's textContextPrefix pattern (regex.js:19-21)."""
    ca = catch_all_regex_str()
    return {
        "max_byte_size": max_byte_size,
        "parts": [
            {"is_public": False, "regex_def": f"({ca}+)?", "max_size": max_byte_size},
            {
                "is_public": False,
                "regex_def": 'Content-Type: text/plain; charset="UTF-8"\r\n\r\n',
                "max_size": 64,
            },
        ],
    }


_REGISTRY = {
    "email_from": from_header_config,
    "email_to": to_header_config,
    "email_subject": subject_config,
    "body_prefix": body_prefix_config,
}


def list_models() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str, max_byte_size: int = 1024) -> DecomposedRegexConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown zoo model {name!r}; available: {list_models()}")
    return DecomposedRegexConfig.from_json(_REGISTRY[name](max_byte_size))


def email_headers_model(max_chars_size: int = 1024, headers=("from", "to", "subject")):
    """The multi-def email-corpus model: one RegexDefs per header, scanned
    simultaneously (the reference's TestCircuit1 pattern of multiple defs at
    once, lib.rs:934-1092)."""
    from .compiled import CompiledRegexModel

    name_map = {"from": "email_from", "to": "email_to", "subject": "email_subject"}
    cfgs = [get_config(name_map[h], max_chars_size) for h in headers]
    return CompiledRegexModel.from_decomposed(cfgs, max_chars_size=max_chars_size)


def dictionary_config(n_words: int = 40, seed: int = 1, max_byte_size: int = 1024) -> dict:
    """A keyword-extraction config in the shape of the structured stress
    model of benchmarks/run_benchmarks.py:407-426 (``config3_structured_
    stress``): ``default_rng(seed)`` draws ``n_words`` random 5-8-letter
    words (the set, sorted), and the parts are ``tag:``, the public word
    alternation and ``\\r\\n``.  With 40 draws it has more than 160
    substring pairs, so ``PallasMatcher``'s ``auto`` mode resolves to
    monolithic."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = sorted({
        "".join(letters[i] for i in rng.integers(0, 26, int(rng.integers(5, 9))))
        for _ in range(n_words)
    })
    return {
        "max_byte_size": max_byte_size,
        "parts": [
            {"is_public": False, "regex_def": "tag:", "max_size": 4},
            {"is_public": True, "regex_def": "(" + "|".join(words) + ")", "max_size": 16},
            {"is_public": False, "regex_def": "\r\n", "max_size": 2},
        ],
    }


def dictionary_model(n_words: int = 40, max_chars_size: int = 1024, seed: int = 1):
    """``dictionary_config`` compiled (``dict40`` with the defaults)."""
    from ..models.compiled import CompiledRegexModel

    cfg = DecomposedRegexConfig.from_json(dictionary_config(n_words, seed, max_chars_size))
    return CompiledRegexModel.from_decomposed([cfg], max_chars_size=max_chars_size)
