"""Sequential CPU oracle for the DFA scan and witness generation.

This is the framework's ground truth: a direct, dictionary-driven
re-implementation of the reference's witness generators and row-assignment
logic (reference: src/lib.rs:804-888 ``derive_states`` /
``derive_substr_ids`` / ``derive_is_start_end`` and src/lib.rs:311-773
``match_substrs``). The PyTorch port's witness pipeline (plain versions
and CUDA kernels) is tested for bit-identical output against this module,
which needs neither JAX nor a GPU.

Divergences from the reference, by design (SURVEY §7/§8.4):
  - an invalid transition propagates the DEAD state and sets ``has_dead``
    instead of panicking (lib.rs:817);
  - the state rows run to index ``max_chars_size`` inclusive (the reference
    assigns only ``max_chars_size`` rows, leaving the row read by the last
    lookup's ``Rotation::next()`` unassigned);
  - for a full-length input (len == max) the final end flag at row ``max``
    is computed honestly (the reference's fixed-size arrays structurally
    zero it, making a substring that touches the very last row
    inextractable).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from ..models.defs import RegexDefs
from ..witness.result import RegexResult

Bytes = Union[bytes, bytearray, Sequence[int], np.ndarray]


def _as_byte_list(characters: Bytes) -> List[int]:
    if isinstance(characters, (bytes, bytearray)):
        return list(characters)
    return [int(c) for c in np.asarray(characters).reshape(-1)]


def derive_states(regex_defs: List[RegexDefs], characters: Bytes):
    """Per-def state sequences of length len+1 (lib.rs:804-823).

    Returns ``(states, has_dead)``. On an invalid transition the reference
    panics; here the state becomes the def's DEAD sentinel
    (largest_state + 2) and stays there.
    """
    chars = _as_byte_list(characters)
    states: List[List[int]] = []
    has_dead: List[bool] = []
    for defs in regex_defs:
        dead = defs.allstr.largest_state_val + 2
        seq = [defs.allstr.first_state_val]
        dead_seen = False
        for ch in chars:
            state = seq[-1]
            if state == dead:
                seq.append(dead)
                continue
            hit = defs.allstr.state_lookup.get((ch, state))
            if hit is None:
                dead_seen = True
                seq.append(dead)
            else:
                seq.append(hit[1])
        states.append(seq)
        has_dead.append(dead_seen)
    return states, has_dead


def derive_substr_ids(regex_defs: List[RegexDefs], states: List[List[int]]):
    """Global substr id per transition; first matching substr wins; ids
    offset across defs starting at 1 (lib.rs:825-845)."""
    substr_ids: List[List[int]] = []
    offset = 1
    for d_idx, defs in enumerate(regex_defs):
        ids = [0] * (len(states[d_idx]) - 1)
        for i in range(len(ids)):
            pair = (states[d_idx][i], states[d_idx][i + 1])
            for s_idx, substr in enumerate(defs.substrs):
                if pair in substr.valid_state_transitions:
                    ids[i] = offset + s_idx
                    break
        substr_ids.append(ids)
        offset += len(defs.substrs)
    return substr_ids


def derive_is_start_end(
    regex_defs: List[RegexDefs],
    states: List[List[int]],
    substr_ids: List[List[int]],
):
    """Start flags (trailing false) and right-shifted end flags
    (lib.rs:847-888)."""
    is_starts_array: List[List[bool]] = []
    is_ends_array: List[List[bool]] = []
    offset = 1
    for d_idx, defs in enumerate(regex_defs):
        st = states[d_idx]
        ids = substr_ids[d_idx]
        n = len(st)
        is_starts = []
        for i in range(n - 1):
            sid = ids[i]
            if sid == 0:
                is_starts.append(False)
            else:
                is_starts.append(st[i] in defs.substrs[sid - offset].start_states)
        is_starts.append(False)
        is_ends = [False]
        for i in range(n - 1):
            sid = ids[i]
            if sid == 0:
                is_ends.append(False)
            else:
                is_ends.append(st[i + 1] in defs.substrs[sid - offset].end_states)
        is_starts_array.append(is_starts)
        is_ends_array.append(is_ends)
        offset += len(defs.substrs)
    return is_starts_array, is_ends_array


def match_substrs(
    regex_defs: List[RegexDefs], characters: Bytes, max_chars_size: int
) -> RegexResult:
    """Full witness generation for one input string (lib.rs:311-773),
    producing every column the reference assigns plus validity flags."""
    chars = _as_byte_list(characters)
    length = len(chars)
    if length > max_chars_size:
        raise ValueError(f"input length {length} exceeds max_chars_size {max_chars_size}")
    n_defs = len(regex_defs)
    mx = max_chars_size

    states_raw, has_dead = derive_states(regex_defs, chars)
    substr_ids_raw = derive_substr_ids(regex_defs, states_raw)
    is_starts_raw, is_ends_raw = derive_is_start_end(
        regex_defs, states_raw, substr_ids_raw
    )

    enable = np.zeros(mx, dtype=np.int32)
    enable[:length] = 1
    characters_arr = np.zeros(mx, dtype=np.int32)
    characters_arr[:length] = chars

    # Per-def padded columns (lib.rs:387-418). Row `length` carries the final
    # state; rows beyond carry dummy = largest + 1.
    states = np.zeros((n_defs, mx + 1), dtype=np.int32)
    substr_ids_per_def = np.zeros((n_defs, mx), dtype=np.int32)
    is_start_vals = np.zeros((n_defs, mx + 1), dtype=np.int32)
    is_end_vals = np.zeros((n_defs, mx + 1), dtype=np.int32)
    accepted = np.zeros(n_defs, dtype=bool)
    for d, defs in enumerate(regex_defs):
        dummy = defs.allstr.largest_state_val + 1
        seq = states_raw[d]
        states[d, : length + 1] = seq
        states[d, length + 1 :] = dummy
        substr_ids_per_def[d, :length] = substr_ids_raw[d]
        is_start_vals[d, : length + 1] = is_starts_raw[d]
        is_end_vals[d, : length + 1] = is_ends_raw[d]
        accepted[d] = seq[length] in defs.accept_set

    # Summed-across-defs columns (lib.rs:459-519). The reference's assigned
    # arrays structurally zero index 0 of is_end and index max of both sums;
    # our honest computation matches except is_end[max] for len == max (see
    # module docstring).
    substr_id_sum = substr_ids_per_def.sum(axis=0).astype(np.int32)
    is_start_sum = is_start_vals.sum(axis=0).astype(np.int32)
    is_start_sum[mx] = 0  # trailing-false by construction; keep explicit
    is_end_sum = is_end_vals.sum(axis=0).astype(np.int32)

    # start/end enable columns feeding the endpoint lookups
    # (lib.rs:483-493, 501-513). end_enable[i] = enable[i] * is_end[i+1].
    start_enable = (enable[None, :] * is_start_vals[:, :mx]).astype(np.int32)
    end_enable = (enable[None, :] * is_end_vals[:, 1 : mx + 1]).astype(np.int32)

    # Forward mask FSM (lib.rs:598-645).
    fwd_mask = np.zeros(mx, dtype=np.int32)
    last = 0
    for i in range(mx):
        pre_id = substr_id_sum[i - 1] if i > 0 else 0
        changed = pre_id != substr_id_sum[i]
        is_set = bool(is_start_sum[i]) and changed
        is_reset = (not bool(is_start_sum[i])) and bool(is_end_sum[i]) and changed
        new = 1 if is_set else (0 if is_reset else last)
        fwd_mask[i] = new
        last = new

    # Backward mask FSM (lib.rs:663-714): iterate positions from the end,
    # then reverse.
    bwd = np.zeros(mx, dtype=np.int32)
    last = 0
    for idx in range(mx):
        j = mx - 1 - idx  # position being decided
        pre_id = substr_id_sum[j + 1] if idx > 0 else 0
        changed = pre_id != substr_id_sum[j]
        set_flag = bool(is_end_sum[j + 1]) and changed
        reset_flag = (
            (not bool(is_end_sum[j + 1])) and bool(is_start_sum[j + 1]) and changed
        )
        new = 1 if set_flag else (0 if reset_flag else last)
        bwd[j] = new
        last = new
    bwd_mask = bwd

    mask = (fwd_mask & bwd_mask).astype(np.int32)
    masked_characters = mask * characters_arr
    all_substr_ids = mask * substr_id_sum

    has_dead_arr = np.asarray(has_dead, dtype=bool)
    match_ok = bool(accepted.all() and not has_dead_arr.any())

    return RegexResult(
        all_enable_flags=enable,
        all_characters=characters_arr,
        all_substr_ids=all_substr_ids,
        masked_characters=masked_characters,
        states=states,
        substr_ids_per_def=substr_ids_per_def,
        start_enable=start_enable,
        end_enable=end_enable,
        is_start_sum=is_start_sum,
        is_end_sum=is_end_sum,
        substr_id_sum=substr_id_sum,
        fwd_mask=fwd_mask,
        bwd_mask=bwd_mask,
        mask=mask,
        accepted=accepted,
        has_dead=has_dead_arr,
        match_ok=np.asarray(match_ok),
    )


def extract_substrings(result: RegexResult):
    """Decode (offset, string, substr_id) runs from a (non-batched) masked
    result — the human-readable view of the extraction."""
    ids = np.asarray(result.all_substr_ids)
    chars = np.asarray(result.masked_characters)
    out = []
    i = 0
    mx = ids.shape[-1]
    while i < mx:
        if ids[i] != 0:
            j = i
            sid = ids[i]
            buf = []
            while j < mx and ids[j] == sid:
                buf.append(int(chars[j]))
                j += 1
            out.append((i, bytes(buf).decode("latin-1"), int(sid)))
            i = j
        else:
            i += 1
    return out
