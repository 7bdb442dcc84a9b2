"""Result container for a regex match + substring extraction.

:class:`RegexResult` is the tensor equivalent of the reference's
``AssignedRegexResult`` (reference: src/lib.rs:79-93) extended with the full
witness column set that the reference assigns during ``match_substrs``
(lib.rs:311-773): per-def state sequences, per-def substr ids, start/end
enables and the forward/backward mask scans. Arrays may be numpy (oracle
path) or torch tensors (device path); an optional leading batch dimension is allowed
on every field.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch


def host(a) -> np.ndarray:
    """``a`` as a numpy array on the host, its dtype kept: a tensor on any
    device is copied to the CPU first (``np.asarray`` of a CUDA tensor
    raises), in C order as JAX's arrays come (a transposed view would
    otherwise save as a Fortran-order npy); anything else goes through
    ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().cpu().numpy()
    return np.asarray(a)


@dataclass
class RegexResult:
    # --- the AssignedRegexResult quartet (lib.rs:79-93) ---
    all_enable_flags: Any  # [*, max]       1 for real chars, 0 for padding
    all_characters: Any  # [*, max]         input bytes, 0-padded
    all_substr_ids: Any  # [*, max]         MASKED substr ids (lib.rs:757-769)
    masked_characters: Any  # [*, max]      mask * char

    # --- extended witness columns ---
    states: Any  # [*, n_defs, max+1]       per-def state seq; final state at
    #                                       row len, dummy beyond (lib.rs:404-418)
    substr_ids_per_def: Any  # [*, n_defs, max]
    start_enable: Any  # [*, n_defs, max]   enable * is_start (lib.rs:483-493)
    end_enable: Any  # [*, n_defs, max]     enable * shifted is_end (lib.rs:501-513)
    is_start_sum: Any  # [*, max+1]         summed across defs (lib.rs:494-498)
    is_end_sum: Any  # [*, max+1]           summed, right-shifted (lib.rs:514-518)
    substr_id_sum: Any  # [*, max]          summed across defs (lib.rs:467-471)
    fwd_mask: Any  # [*, max]               forward set/reset FSM (lib.rs:598-645)
    bwd_mask: Any  # [*, max]               backward FSM, reversed (lib.rs:663-714)
    mask: Any  # [*, max]                   fwd & bwd (lib.rs:740-745)

    # --- validity ---
    accepted: Any  # [*, n_defs]            final state == accepted state
    has_dead: Any  # [*, n_defs]            an invalid transition occurred
    #                                       (reference panics instead, lib.rs:817)
    match_ok: Any  # [*]                    all defs accepted and no dead

    def astuple(self):
        return tuple(getattr(self, f.name) for f in fields(self))

    @classmethod
    def field_names(cls):
        return [f.name for f in fields(cls)]

    def map(self, fn) -> "RegexResult":
        return RegexResult(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})

    def to_numpy(self) -> "RegexResult":
        """Every field as a numpy array (``host``): a result on the card
        comes to the host, dtypes kept."""
        return self.map(host)
