"""Dense tensor packing of regex models for the device scan path.

The reference keeps its DFA as a ``HashMap<(u8, u64), (usize, u64)>``
(reference: src/defs.rs:28) and scans it byte-by-byte on the host
(lib.rs:804-823). Here the same information is packed into dense arrays
laid out for device gathers:

  - ``transition[n_defs, 256, s_pad]``: next-state table; missing
    transitions and the DUMMY/DEAD rows map to the per-def DEAD sentinel;
  - ``substr_id_table[n_defs, s_pad, s_pad]``: (cur, next) -> global
    substr id (0 = none; first matching substr wins with cross-def offsets,
    lib.rs:825-845 / table.rs:109-122);
  - ``is_start_table/is_end_table[total_substrs + 1, s_pad]``: membership of
    a state in a substr's start/end state sets (row 0 = no-substr = False).

State-id conventions per def (SURVEY §8.4): real states ``0..largest``,
DUMMY = ``largest + 1`` (padding rows, table.rs:67), DEAD = ``largest + 2``
(invalid-transition sentinel — the reference panics instead, lib.rs:817).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .defs import AllstrRegexDef, RegexDefs, SubstrRegexDef


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class CompiledRegexModel:
    """A batch-scannable, device-ready packing of ``Vec<RegexDefs>``."""

    regex_defs: List[RegexDefs]
    max_chars_size: int
    s_pad: int
    transition: np.ndarray  # int32 [n_defs, 256, s_pad]
    substr_id_table: np.ndarray  # int32 [n_defs, s_pad, s_pad]
    first_states: np.ndarray  # int32 [n_defs]
    accepted_states: np.ndarray  # int32 [n_defs]
    dummy_states: np.ndarray  # int32 [n_defs]  (largest + 1)
    dead_states: np.ndarray  # int32 [n_defs]   (largest + 2)
    substr_offsets: np.ndarray  # int32 [n_defs] (first global id per def)
    is_start_table: np.ndarray  # bool [total_substrs + 1, s_pad]
    is_end_table: np.ndarray  # bool [total_substrs + 1, s_pad]
    # Acceptance-set membership per def (opt-in multi-accept extension;
    # defaults to the one-hot of accepted_state_val = reference semantics,
    # defs.rs:31-33).
    accept_mask: np.ndarray = None  # bool [n_defs, s_pad]

    def __post_init__(self):
        if self.accept_mask is None:
            mask = np.zeros((len(self.regex_defs), self.s_pad), bool)
            for d, defs in enumerate(self.regex_defs):
                for a in defs.accept_set:
                    mask[d, a] = True
            self.accept_mask = mask

    @property
    def n_defs(self) -> int:
        return len(self.regex_defs)

    @property
    def total_substrs(self) -> int:
        return self.is_start_table.shape[0] - 1

    # ------------------------------------------------------------------
    @classmethod
    def from_defs(
        cls,
        regex_defs: List[RegexDefs],
        max_chars_size: int,
        state_pad_multiple: int = 8,
    ) -> "CompiledRegexModel":
        n_defs = len(regex_defs)
        largest = [d.allstr.largest_state_val for d in regex_defs]
        s_needed = max(l + 3 for l in largest)  # room for DUMMY and DEAD
        s_pad = _round_up(s_needed, state_pad_multiple)

        first_states = np.array([d.allstr.first_state_val for d in regex_defs], np.int32)
        accepted_states = np.array(
            [d.allstr.accepted_state_val for d in regex_defs], np.int32
        )
        accept_mask = np.zeros((n_defs, s_pad), bool)
        for d, defs in enumerate(regex_defs):
            for a in defs.accept_set:
                accept_mask[d, a] = True
        dummy_states = np.array([l + 1 for l in largest], np.int32)
        dead_states = np.array([l + 2 for l in largest], np.int32)

        transition = np.empty((n_defs, 256, s_pad), np.int32)
        for d, defs in enumerate(regex_defs):
            transition[d] = dead_states[d]
            for (char, cur), (_, nxt) in defs.allstr.state_lookup.items():
                transition[d, char, cur] = nxt

        total_substrs = sum(len(d.substrs) for d in regex_defs)
        substr_offsets = np.zeros(n_defs, np.int32)
        off = 1  # global ids start at 1 (lib.rs:780-784)
        substr_id_table = np.zeros((n_defs, s_pad, s_pad), np.int32)
        is_start_table = np.zeros((total_substrs + 1, s_pad), bool)
        is_end_table = np.zeros((total_substrs + 1, s_pad), bool)
        for d, defs in enumerate(regex_defs):
            substr_offsets[d] = off
            # First matching substr wins: iterate in reverse so earlier
            # substrs overwrite later ones (lib.rs:831-840).
            for j in range(len(defs.substrs) - 1, -1, -1):
                substr = defs.substrs[j]
                gid = off + j
                for cur, nxt in substr.valid_state_transitions:
                    substr_id_table[d, cur, nxt] = gid
                for s in substr.start_states:
                    is_start_table[gid, s] = True
                for e in substr.end_states:
                    is_end_table[gid, e] = True
            off += len(defs.substrs)

        return cls(
            regex_defs=regex_defs,
            max_chars_size=max_chars_size,
            s_pad=s_pad,
            transition=transition,
            substr_id_table=substr_id_table,
            first_states=first_states,
            accepted_states=accepted_states,
            dummy_states=dummy_states,
            dead_states=dead_states,
            substr_offsets=substr_offsets,
            is_start_table=is_start_table,
            is_end_table=is_end_table,
            accept_mask=accept_mask,
        )

    @classmethod
    def from_texts(
        cls,
        allstr_substr_texts,  # List[Tuple[str, List[str]]]
        max_chars_size: int,
        **kw,
    ) -> "CompiledRegexModel":
        regex_defs = [
            RegexDefs(
                allstr=AllstrRegexDef.read_from_str(allstr),
                substrs=[SubstrRegexDef.read_from_str(s) for s in substrs],
            )
            for allstr, substrs in allstr_substr_texts
        ]
        return cls.from_defs(regex_defs, max_chars_size, **kw)

    @classmethod
    def from_decomposed(
        cls,
        configs,
        max_chars_size: Optional[int] = None,
        multi_accept: bool = False,
        **kw,
    ):
        """Compile one or more DecomposedRegexConfig objects into a model.

        ``multi_accept``: honor EVERY accepting DFA state (opt-in extension
        fixing the reference's optional-tail footgun, defs.rs:31-33 /
        warn_if_multi_accept); default keeps reference semantics (first
        accepting state only).
        """
        from ..compiler.decomposed import DecomposedRegexConfig
        from ..compiler.pipeline import dfa_to_regex_def_text

        if isinstance(configs, DecomposedRegexConfig):
            configs = [configs]
        texts = []
        accept_sets = []
        for cfg in configs:
            nodes = cfg.compile_dfa()
            texts.append((dfa_to_regex_def_text(nodes), cfg.substr_texts()))
            accept_sets.append(
                [i for i, n in enumerate(nodes) if n.type == "accept"]
            )
        if max_chars_size is None:
            max_chars_size = max(cfg.max_byte_size for cfg in configs)
        model = cls.from_texts(texts, max_chars_size, **kw)
        if multi_accept:
            for d, accepts in enumerate(accept_sets):
                model.regex_defs[d].accept_states = accepts
                model.accept_mask[d, :] = False
                model.accept_mask[d, accepts] = True
        else:
            for d, accepts in enumerate(accept_sets):
                if len(accepts) > 1:
                    import warnings

                    warnings.warn(
                        f"def {d}: DFA has {len(accepts)} accepting states "
                        f"{accepts}; reference single-accept semantics keep "
                        "only the first — inputs reaching the others are "
                        "REJECTED (typical cause: an optional tail like "
                        "'(x)?'). Pass multi_accept=True to honor every "
                        "accepting state.",
                        stacklevel=2,
                    )
        return model

    # ------------------------------------------------------------------
    # Artifact I/O — the compile-once/reload-forever layer (the reference
    # uses its text files for this, SURVEY §5.4).
    def save(self, path) -> None:
        meta = {
            "max_chars_size": self.max_chars_size,
            "s_pad": self.s_pad,
            "accept_states": [d.accept_states for d in self.regex_defs],
            "allstr_texts": [d.allstr.to_text() for d in self.regex_defs],
            "substr_texts": [[s.to_text() for s in d.substrs] for d in self.regex_defs],
        }
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            transition=self.transition,
            substr_id_table=self.substr_id_table,
            first_states=self.first_states,
            accepted_states=self.accepted_states,
            dummy_states=self.dummy_states,
            dead_states=self.dead_states,
            substr_offsets=self.substr_offsets,
            is_start_table=self.is_start_table,
            is_end_table=self.is_end_table,
            accept_mask=self.accept_mask,
        )

    @classmethod
    def from_jax_arrays(cls, arrays) -> "CompiledRegexModel":
        """Rebuild a model from the arrays the JAX package's
        ``CompiledRegexModel.save`` writes: a mapping with ``meta`` (JSON
        bytes as a uint8 array) and the table arrays under their field
        names.  Both packages then run the very same tables."""
        meta = json.loads(bytes(np.asarray(arrays["meta"])).decode())
        accepts = meta.get("accept_states", [None] * len(meta["allstr_texts"]))
        regex_defs = [
            RegexDefs(
                allstr=AllstrRegexDef.read_from_str(a),
                substrs=[SubstrRegexDef.read_from_str(s) for s in subs],
                accept_states=acc,
            )
            for a, subs, acc in zip(
                meta["allstr_texts"], meta["substr_texts"], accepts
            )
        ]
        return cls(
            regex_defs=regex_defs,
            max_chars_size=meta["max_chars_size"],
            s_pad=meta["s_pad"],
            transition=np.asarray(arrays["transition"]),
            substr_id_table=np.asarray(arrays["substr_id_table"]),
            first_states=np.asarray(arrays["first_states"]),
            accepted_states=np.asarray(arrays["accepted_states"]),
            dummy_states=np.asarray(arrays["dummy_states"]),
            dead_states=np.asarray(arrays["dead_states"]),
            substr_offsets=np.asarray(arrays["substr_offsets"]),
            is_start_table=np.asarray(arrays["is_start_table"]),
            is_end_table=np.asarray(arrays["is_end_table"]),
            accept_mask=np.asarray(arrays["accept_mask"])
            if "accept_mask" in arrays
            else None,
        )

    @classmethod
    def load(cls, path) -> "CompiledRegexModel":
        """Read a ``.npz`` written by ``save`` here or in the JAX package."""
        with np.load(path) as z:
            return cls.from_jax_arrays({k: z[k] for k in z.files})
