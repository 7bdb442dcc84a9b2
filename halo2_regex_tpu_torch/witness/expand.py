"""Expand the compact witness emission back to the full column set.

The bitplane backend's ``columns="witness"`` mode emits the BASELINE
ScanTraffic column set (~6 B/input byte): per-def state rows, masked ids,
masked characters and one packed flags byte.  That set plus the raw input
is sufficient witness data — every remaining ``RegexResult`` column is a
pure per-row function of adjacent states (reference src/lib.rs:825-888:
substr ids, start/end flags are functions of the (prev, next) state
pair).  :func:`expand_witness` reconstructs the full column set so the
constraint checker (witness/checker.py, the MockProver equivalent) and
the npz serialization layer can consume compact-mode outputs unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.compiled import CompiledRegexModel
from .result import RegexResult, host


def expand_witness(
    model: CompiledRegexModel, w: Dict[str, np.ndarray], chars: np.ndarray
) -> RegexResult:
    """Reconstruct a full :class:`RegexResult` from a compact witness dict.

    Args:
      model: the compiled model the witness was generated with.
      w: the dict returned by ``BitplaneMatcher(columns="witness")``
        (tensors on any device, or numpy arrays).
      chars: the raw input bytes ``[B, L]`` (the compact set carries only
        masked characters; unmasked bytes come from the caller's input),
        a tensor on any device or a numpy array.

    Derivations mirror ops/scan_torch._match_core (the JAX package's
    scan_jax._match_core) exactly (itself pinned to the oracle): ids/flags
    are table lookups on (prev, next) state pairs, sums across defs,
    enables multiplied in; fwd/bwd/mask come from the emitted flags byte
    rather than being recomputed.
    """
    flags = host(w["flags"])
    states = host(w["states"]).astype(np.int64)  # [B, n_defs, L+1]
    B, n_defs, L1 = states.shape
    L = L1 - 1
    chars = host(chars)
    assert chars.shape == (B, L), (chars.shape, (B, L))

    enable = ((flags >> 3) & 1).astype(np.int32)
    fwd = ((flags >> 1) & 1).astype(np.int32)
    bwd = ((flags >> 2) & 1).astype(np.int32)
    mask = (flags & 1).astype(np.int32)

    # The compact `states` rows are dummy-filled beyond the input
    # (lib.rs:404-418).  The id/flag tables treat the gid-0 row and the
    # dummy column as inert, so lookups on dummy-filled rows match lookups
    # on the raw propagated states once multiplied by enable.
    assert not model.is_start_table[0].any() and not model.is_end_table[0].any()

    prev = states[:, :, :L]
    nxt = states[:, :, 1:]
    ids_per_def = (
        model.substr_id_table[
            np.arange(n_defs)[None, :, None], prev, nxt
        ].astype(np.int32)
        * enable[:, None, :]
    )

    is_start_body = model.is_start_table[ids_per_def, prev].astype(np.int32)
    is_start_vals = np.concatenate(
        [is_start_body, np.zeros((B, n_defs, 1), np.int32)], axis=2
    )
    is_end_body = model.is_end_table[ids_per_def, nxt].astype(np.int32)
    is_end_vals = np.concatenate(
        [np.zeros((B, n_defs, 1), np.int32), is_end_body], axis=2
    )

    substr_id_sum = ids_per_def.sum(axis=1)
    is_start_sum = is_start_vals.sum(axis=1)
    is_end_sum = is_end_vals.sum(axis=1)
    start_enable = enable[:, None, :] * is_start_vals[:, :, :L]
    end_enable = enable[:, None, :] * is_end_vals[:, :, 1:]

    return RegexResult(
        all_enable_flags=enable,
        all_characters=chars.astype(np.int32) * enable,
        all_substr_ids=host(w["all_substr_ids"]).astype(np.int32),
        masked_characters=host(w["masked_characters"]).astype(np.int32),
        states=states.astype(np.int32),
        substr_ids_per_def=ids_per_def,
        start_enable=start_enable,
        end_enable=end_enable,
        is_start_sum=is_start_sum,
        is_end_sum=is_end_sum,
        substr_id_sum=substr_id_sum,
        fwd_mask=fwd,
        bwd_mask=bwd,
        mask=mask,
        accepted=host(w["accepted"]),
        has_dead=host(w["has_dead"]),
        match_ok=host(w["match_ok"]),
    )
