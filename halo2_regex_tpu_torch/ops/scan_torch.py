"""Portable batched scan, PyTorch port of ``halo2_regex_tpu/ops/scan_jax.py``.

The JAX module is the package's headline entry point (``BatchMatcher``):
witness generation for a padded batch, the tensor form of the reference's
host-side witness generation (reference: src/lib.rs:311-773, 804-888).  In
JAX it is XLA: a ``lax.scan`` over positions carrying one state per
(string, def), then gathers and two ``lax.scan`` mask FSMs.  Here:

  - the per-byte DFA recurrence of every def runs through the table scan
    of the split matcher (``pallas_scan.scan``: on the card the
    hand-written ``csrc/table_scan.cu``, serial or chunked by
    ``kernels.table_scan_form``; on the CPU ``scan_plain``), on a byte ->
    class map built from the rows of ``model.transition[d]``
    (``pallas_scan.byte_classes``): two bytes with equal rows give equal
    next states, so the map is exact, and the class table of a large DFA
    fits the kernel's shared memory where the 256-row one would not;
  - the substring-id, start and end gathers and the final state are torch
    ops, computed time-major (the scan's layout), one def at a time;
  - each mask FSM (``new = set ? 1 : reset ? 0 : last``) is a running max
    along the positions (``mask_fsm``), not a loop over L;
  - the tail (dummy states, sums, mask, verdicts) is the table matcher's
    ``pallas_scan.finish_planes``.

Every output equals the JAX ``BatchMatcher``'s, dtypes included
(tests/test_torch_scan.py).  ``prefix_transition_maps`` composes the
per-byte maps by log-step doubling; ``expand_rows`` gathers padded rows
from a flat corpus buffer on the device (``ScanJob(device_expand=True)``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models.compiled import CompiledRegexModel
from ..witness.result import RegexResult
from .bitplane import _round_up, resolve_device
from .pallas_scan import byte_classes, finish_planes, scan, scan_plain

# the constants of a model (JAX's nine, then the scan's class tables)
ARRAY_KEYS = ("transition", "substr_id_table", "first_states", "accepted_states", "accept_mask",
              "dummy_states", "dead_states", "is_start_table", "is_end_table", "class_map",
              "next_table", "next_table16")


def class_tables(transition: np.ndarray):
    """The table scan's tables for next-state tables ``transition``
    [n_defs, 256, S]: the byte -> class map [n_defs, 256] and the class
    table [n_defs, K, S] int32 (each def's distinct rows; K the widest
    def's count rounded up to 8), and the kernel's shared-memory table
    ``2 * next`` as uint16 bits in int16 (None past 32768 states)."""
    transition = np.asarray(transition, np.int32)
    n_defs, _, S = transition.shape
    maps, rows = zip(*(byte_classes(transition[d]) for d in range(n_defs)))
    K = _round_up(max(max(r.shape[0] for r in rows), 8), 8)
    nxt = np.zeros((n_defs, K, S), np.int32)
    for d, r in enumerate(rows):
        nxt[d, : r.shape[0]] = r
    next16 = (2 * nxt).astype(np.uint16).view(np.int16) if S <= 32768 else None
    return np.stack(maps), nxt, next16


def _model_arrays(model: CompiledRegexModel) -> dict:
    """The device-side constants of a model as a dict of CPU tensors:
    JAX's nine (same dtypes: int32, the membership tables and the accept
    mask bool) and the scan's ``class_tables``."""
    bools = ("accept_mask", "is_start_table", "is_end_table")
    arrays = {k: torch.from_numpy(np.asarray(getattr(model, k), bool if k in bools else np.int32))
              for k in ARRAY_KEYS[:9]}
    cmap, nxt, next16 = class_tables(model.transition)
    arrays.update(class_map=torch.from_numpy(cmap), next_table=torch.from_numpy(nxt),
                  next_table16=None if next16 is None else torch.from_numpy(next16))
    return arrays


def arrays_on(arrays: dict, device) -> dict:
    """A dict of ``_model_arrays`` with each tensor moved to ``device``."""
    return {k: None if v is None else v.to(device) for k, v in arrays.items()}


def _scan_tm(arrays: dict, chars: torch.Tensor, init: torch.Tensor, plain: bool) -> torch.Tensor:
    """States [n_defs, L, B] int32 after each byte of ``chars`` [B, L]
    uint8 from ``init`` [n_defs, B] int32 (the bytes past each length are
    scanned too, as JAX scans them): the table scan kernel on the card,
    ``scan_plain`` on the CPU or with ``plain``."""
    B, L = chars.shape
    cmap, nxt = arrays["class_map"], arrays["next_table"]
    out = torch.empty((nxt.shape[0], L, B), dtype=torch.int32, device=chars.device)
    if plain:
        scan_plain(cmap, nxt, chars, init, 0, L, out)
    else:
        scan(cmap, nxt, chars, init, 0, L, out, next16=arrays["next_table16"])
    return out


def scan_states(transition, first_state, chars) -> torch.Tensor:
    """Run the per-byte DFA recurrence for one def over a batch.

    Args:
      transition: int32 [256, S] next-state table (DEAD-completed).
      first_state: scalar initial state.
      chars: uint8/int32 [B, L] padded input bytes (a tensor: its device
        picks the scan; a numpy array runs on the CPU).

    Returns:
      int32 [B, L+1] raw state sequences (state 0 is the initial state;
      padding positions keep transitioning on their bytes -- callers mask).
    """
    chars = torch.as_tensor(chars)
    dev = chars.device
    cmap, nxt, next16 = class_tables(np.asarray(torch.as_tensor(transition).cpu())[None])
    arrays = dict(class_map=torch.from_numpy(cmap).to(dev),
                  next_table=torch.from_numpy(nxt).to(dev),
                  next_table16=None if next16 is None else torch.from_numpy(next16).to(dev))
    B = chars.shape[0]
    init = torch.full((1, B), int(first_state), dtype=torch.int32, device=dev)
    states = _scan_tm(arrays, chars.to(torch.uint8).contiguous(), init, False)[0]  # [L, B]
    return torch.cat([init, states]).t()


def prefix_transition_maps(transition, chars) -> torch.Tensor:
    """All-prefix composed transition maps.

    Args:
      transition: int32 [256, S].
      chars: int [L] byte sequence (single string).

    Returns:
      int32 [L, S]: ``maps[i][s]`` = state after consuming ``chars[:i+1]``
      starting from state ``s``.  Log-step doubling (Hillis-Steele): after
      the step of shift k, row i holds the composition of rows
      max(0, i - 2k + 1) .. i.  Compositions of integer maps are exact, so
      this equals JAX's ``associative_scan`` bit for bit.
    """
    transition = torch.as_tensor(transition)
    maps = transition[torch.as_tensor(chars, device=transition.device).long()]  # [L, S]
    shift = 1
    while shift < maps.shape[0]:
        # apply the earlier maps first: (g o f)[x] = g[f[x]]
        later = maps.clone()
        later[shift:] = torch.gather(maps[shift:], 1, maps[:-shift].long())
        maps = later
        shift *= 2
    return maps.to(torch.int32)


def _running_max(key: torch.Tensor) -> torch.Tensor:
    """Running max along dim 0 of a non-negative int32 tensor [L, ...], in
    two levels so that every scan is short and the scans run side by side
    (torch scans a non-last dim one thread a column): the max within each
    chunk of about sqrt(L) positions, then the running max of the chunks'
    maxima, carried into the next chunk."""
    L, *rest = key.shape
    cl = 1 << ((max(L, 1) - 1).bit_length() + 1) // 2  # a power of 2 near sqrt(L)
    n = -(-L // cl)
    if n * cl != L:
        key = torch.cat([key, key.new_zeros((n * cl - L, *rest))])
    within = key.reshape(n, cl, *rest).cummax(1).values
    carry = within[:, -1].cummax(0).values
    carry = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])  # the chunks before each
    return torch.maximum(within, carry[:, None]).reshape(n * cl, *rest)[:L]


def mask_fsm(set_: torch.Tensor, reset: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The set/reset/hold mask FSM (src/lib.rs:598-714), ``new = set ? 1 :
    reset ? 0 : last`` from 0, along dim 0 of the bool planes ``set_`` and
    ``reset`` [L, ...] (descending with ``reverse``) -> int32 [L, ...].
    The value at position i is that of the last set-or-reset position at or
    before i in walk order (0 where there is none): each such position is
    keyed 2 (k + 1) + set, k its step in the walk, so the running max of
    the keys picks the last one and its low bit is its value (set wins
    over reset at one position, as in the recurrence)."""
    if reverse:
        return mask_fsm(set_.flip(0), reset.flip(0)).flip(0)
    L = set_.shape[0]
    step = torch.arange(2, 2 * L + 2, 2, dtype=torch.int32, device=set_.device)
    step = step.reshape(L, *([1] * (set_.dim() - 1)))
    return _running_max(torch.where(set_ | reset, step + set_.to(torch.int32), 0)) & 1


def _match_core(arrays: dict, n_defs: int, chars: torch.Tensor, lengths: torch.Tensor,
                plain: bool = False) -> dict:
    """Witness generation for a batch (``chars`` [B, L] uint8, ``lengths``
    [B] int32, on the device of ``arrays``, ``_model_arrays``).  Returns a
    dict of the 17 ``RegexResult`` columns with the JAX shapes and dtypes.
    ``plain``: the plain scan on any device (the reference the card's
    kernel path is held against)."""
    B, L = chars.shape
    i32 = torch.int32
    first = arrays["first_states"]
    firsts = first[:, None].expand(n_defs, B).contiguous()
    states = _scan_tm(arrays, chars, firsts, plain)  # [n_defs, L, B]

    # substr ids on transitions (lib.rs:825-845), 0 beyond the input; the
    # start/end flags (lib.rs:847-888) of (ids[i], state[i]) and
    # (ids[i], state[i+1]): the membership tables are global across defs
    enable = (torch.arange(L, dtype=i32, device=chars.device)[:, None]
              < lengths[None, :]).to(i32)  # [L, B]
    S = arrays["transition"].shape[-1]
    Ssub = arrays["is_start_table"].shape[-1]
    st_flat = arrays["is_start_table"].reshape(-1)
    en_flat = arrays["is_end_table"].reshape(-1)
    ids, start, endf = (torch.empty_like(states) for _ in range(3))
    for d in range(n_defs):
        nxt = states[d]
        prev = torch.cat([firsts[d][None], nxt[:-1]])
        ids[d] = arrays["substr_id_table"][d].reshape(-1)[prev.long() * S + nxt] * enable
        start[d] = st_flat[ids[d].long() * Ssub + prev]
        endf[d] = en_flat[ids[d].long() * Ssub + nxt]

    # the mask FSMs (lib.rs:598-714) on the sums over defs: the forward
    # one reads the previous position's ids and end flags, the backward
    # one the next position's ids and start flags (0 past the ends)
    ids_sum, st_any, ef_any = (t.sum(0, dtype=i32) for t in (ids, start, endf))
    zero = torch.zeros_like(ids_sum[:1])
    st_any, ef_any = st_any != 0, ef_any != 0
    changed = torch.cat([zero, ids_sum[:-1]]) != ids_sum
    prev_ef = torch.cat([zero.bool(), ef_any[:-1]])
    fwd = mask_fsm(st_any & changed, ~st_any & prev_ef & changed)
    changed = torch.cat([ids_sum[1:], zero]) != ids_sum
    next_st = torch.cat([st_any[1:], zero.bool()])
    bwd = mask_fsm(ef_any & changed, ~ef_any & next_st & changed, reverse=True)
    del ids_sum, changed, prev_ef, next_st
    return vars(finish_planes(first, arrays["dummy_states"], arrays["dead_states"],
                              arrays["accept_mask"], chars, lengths, states, ids, start, endf,
                              fwd, bwd))


class BatchMatcher(nn.Module):
    """The batched matcher for one compiled model (port of the JAX
    ``BatchMatcher``): a call returns a ``RegexResult`` equal to the JAX
    matcher's, dtypes included.

    ``device``: ``"cuda"`` (the default) runs the table scan kernel and the
    torch ops on the card and raises where CUDA is absent; ``"cpu"`` runs
    the plain scan.

    Usage::

        matcher = BatchMatcher(model)
        result = matcher(chars_u8_BxL, lengths_B)   # RegexResult of tensors
    """

    def __init__(self, model: CompiledRegexModel, device="cuda"):
        super().__init__()
        self.model = model
        self.n_defs = model.n_defs
        self.L = model.max_chars_size
        for k, v in _model_arrays(model).items():
            self.register_buffer(k, v)
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.transition.device

    def run(self, chars: torch.Tensor, lengths: torch.Tensor, plain: bool = False) -> RegexResult:
        """``_match_core`` on ``chars`` [B, L] uint8 and ``lengths`` [B]
        int32 on the matcher's device; ``plain`` runs the plain scan there
        (the reference the kernel path is held against)."""
        B, L = chars.shape
        if L != self.L:
            raise ValueError(f"chars are [B, {L}]; the model needs L={self.L}")
        if tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths {tuple(lengths.shape)}: expected ({B},)")
        arrays = {k: getattr(self, k) for k in ARRAY_KEYS}  # on the matcher's device
        return RegexResult(**_match_core(arrays, self.n_defs, chars, lengths, plain))

    @torch.no_grad()
    def forward(self, chars, lengths) -> RegexResult:
        chars = torch.as_tensor(chars, dtype=torch.uint8, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return self.run(chars.contiguous(), lengths.contiguous())

    def match_one(self, characters: bytes) -> RegexResult:
        """Single-string convenience matching the oracle's signature; numpy
        rows."""
        buf = np.zeros((1, self.L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        res = self(buf, np.array([len(characters)], np.int32))
        return res.map(lambda v: v[0].cpu().numpy())


def expand_rows(flat: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                max_len: int) -> torch.Tensor:
    """Gather padded [B, max_len] uint8 rows from a flat corpus buffer on
    the device (the device-expand corpus path).

    ``flat`` uint8 [total]; ``starts`` int [B] byte offsets; ``lengths``
    int32 [B] row lengths (<= max_len).  Positions past a row's length are
    zero, identical to the host packer's padding, so downstream matchers
    see the same batches while only the raw corpus bytes cross the
    host->device link."""
    # JAX indexes in int32 and refuses a buffer it would wrap; the port
    # takes the same inputs
    if flat.shape[0] >= 2**31:
        raise ValueError(
            f"flat corpus buffer of {flat.shape[0]} bytes exceeds int32 "
            "indexing; use chunk_bytes < 2 GiB"
        )
    pos = torch.arange(max_len, device=flat.device)
    valid = pos[None, :] < lengths[:, None]
    idx = torch.where(valid, starts[:, None].long() + pos[None, :], 0)
    return torch.where(valid, flat[idx], 0)
