"""Table-driven matcher, PyTorch port.

The module and class names follow the JAX package's
``halo2_regex_tpu.ops.pallas_scan.PallasMatcher`` so that a reader finds the
counterpart; the kernels here are hand-written CUDA (``csrc/table_scan.cu``,
``csrc/table_tag.cu``, ``csrc/table_fsm.cu``, ``csrc/table_flat.cu``,
bound by :mod:`.kernels`), not Pallas.  This is the device path for DFAs
the bitplane budget refuses: more than 256 states, large circuits, long
inputs.  The JAX matcher's split mode runs three stages over L-windows:

  1. **scan** (B8; B11 per segment): the only sequential stage.  Per def,
     s = next[cls[c], s] for each byte: a byte -> class map [n_defs, 256]
     and a next-state table [n_defs, K, S] (a model beyond 256 states
     stores ``lo + 256*hi``, the transition itself).  Writes states
     [n_defs, L, B], time-major.
  2. **tag** (B9/B11): ids, is_start and is_end per (prev, next) state pair
     from the pair list [n_defs, P, 5] of (a, b, gid, is_start, is_end),
     masked by pos < length.  Position-parallel.
  3. **fsm** (B10/B11): sums over defs, then the forward or backward
     set/reset/hold mask FSM [L, B].

``grid_mode="batch"`` runs each stage once over [0, L); ``"segmented"``
runs them over ``n_seg`` windows of ``segment`` positions, with the carries
(the scan's entry state, the tag's previous state row, the FSMs' entry
value and neighbouring id/flag rows) passed as arguments.  Every output
window lies in one full-length tensor, so no segment is concatenated.
The windows are the TPU's VMEM budget: the plain pipeline keeps them, and
the card runs each stage once over [0, L) (its planes fit device memory),
the scan and the FSMs spread over chunks of L where the batch alone would
leave the card idle.

``mode="monolithic"`` (what ``auto`` resolves to when a def has more than
``max_pairs`` pairs, so the tag stage's pair list would be long) runs one
**flat** stage (B12) over the whole L instead: the scan picks, with each
transition, a packed entry ``next | id << 8 | start << 24 | endf << 25``
of a [n_defs, K, S] table, and runs the forward FSM in the same loop and
the backward FSM as a reversed pass.  It writes the same time-major planes,
so the finish is shared.

The TPU's stride-2 pair tables, slab unrolling, joint-def tables and the
bf16/int8 one-hot MXU select exist to get exact integer gathers out of the
TPU's matrix unit; the card gathers directly and the integers are the same,
so they are not carried.

Each stage has a plain PyTorch version here (``scan_plain``, ``tag_plain``,
``fsm_plain``, ``flat_plain``) and routes by device (``scan``, ``tag``,
``fsms``, ``flat``): a CPU tensor takes the plain version, a CUDA tensor
launches the kernel (or raises).  There is no fallback.  The chunked forms
of the scan and FSM kernels, the FSM kernel's one-pass form (both
directions from one read of the planes, the backward ops packed in 2 bits)
and the flat kernel's bit-packed backward column have torch twins too
(``scan_chunks_plain``, ``fsm_chunks_plain``, ``fsm_pass_plain``,
``flat_bits_plain``), which the tests hold to the plain versions.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.compiled import CompiledRegexModel
from ..witness.result import RegexResult
from .bitplane import _kernels, _on_cuda, _round_up, _substr_pairs, resolve_device
from .bitplane import _to_int32 as _as_int32

PAIR_FIELDS = 5  # (a, b, gid, is_start, is_end); a = -1 pads a def's list
# the flat table's packed entry: next state | substring id | start | end
FLAT_ID_SHIFT, FLAT_START_SHIFT, FLAT_ENDF_SHIFT = 8, 24, 25
FLAT_GROUP_DEFS = 8  # kGroupDefs of csrc/table_flat.cu: defs a pass of its scan carries


# ---------------------------------------------------------------------------
# Host phases (numpy), carried from the JAX module
# ---------------------------------------------------------------------------


def build_packed_tables(model: CompiledRegexModel) -> np.ndarray:
    """Per-def [256, 4*S] packed tables: next | substr_id | is_start | is_end.

    ``is_start``/``is_end`` are per-transition flags as functions of
    (char, cur): id = substr_id_table[cur, next]; is_start = id!=0 and
    cur in start_states(id); is_end = id!=0 and next in end_states(id)
    (the oracle's is_end at index i+1, i.e. unshifted).
    """
    S = model.s_pad
    assert S <= 256, f"s_pad {S} > 256 breaks bf16 exactness"
    assert model.total_substrs <= 256, "substr ids > 256 break bf16 exactness"
    n_defs = model.n_defs
    out = np.zeros((n_defs, 256, 4 * S), np.float32)
    for d in range(n_defs):
        T = model.transition[d]  # [256, S]
        sub = model.substr_id_table[d]  # [S, S]
        cur = np.arange(S)[None, :].repeat(256, 0)
        nxt = T
        ids = sub[cur, nxt]
        out[d, :, 0 * S : 1 * S] = nxt
        out[d, :, 1 * S : 2 * S] = ids
        out[d, :, 2 * S : 3 * S] = model.is_start_table[ids, cur]
        out[d, :, 3 * S : 4 * S] = model.is_end_table[ids, nxt]
    return out


def byte_classes(packed_def: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse the 256 byte rows of one def's packed table into
    equivalence classes. Returns (class_of [256] int32, class_table
    [k, 4S] f32)."""
    uniq, inverse = np.unique(packed_def, axis=0, return_inverse=True)
    return inverse.reshape(-1).astype(np.int32), uniq.astype(np.float32)


def class_boundaries(class_of: np.ndarray) -> Tuple[int, List[Tuple[int, int]]]:
    """Represent the byte->class map as cls(c) = cls0 + Σ Δ_r·(c >= b_r).
    Returns (cls0, [(b_r, Δ_r)...]) with one term per point where the map
    changes as c increases."""
    cls0 = int(class_of[0])
    terms = []
    for c in range(1, 256):
        d = int(class_of[c]) - int(class_of[c - 1])
        if d != 0:
            terms.append((c, d))
    return cls0, terms


# ---------------------------------------------------------------------------
# Stage 1: scan (B8 / B11 scan on the card)
# ---------------------------------------------------------------------------


def scan_plain(cmap, next_tab, chars, init, p0: int, LS: int, out) -> None:
    """Window [p0, p0 + LS) of the serial table scan, written into
    ``out[:, p0:p0 + LS]``.  ``cmap`` [n_defs, 256] and ``next_tab``
    [n_defs, K, S] int32, ``chars`` [B, L] uint8, ``init`` [n_defs, B] int32
    (the state before position p0), ``out`` [n_defs, L, B] int32.  The scan
    runs over the buffer's bytes past each string's length, as JAX does."""
    S = next_tab.shape[2]
    c = chars[:, p0 : p0 + LS].long()
    for d in range(next_tab.shape[0]):
        off = (cmap[d].long()[c] * S).t().contiguous()  # [LS, B]
        flat = next_tab[d].reshape(-1)
        s = init[d].long()
        rows = []
        for p in range(LS):
            s = flat[off[p] + s].long()
            rows.append(s)
        out[d, p0 : p0 + LS] = torch.stack(rows).to(torch.int32)


def scan(cmap, next_tab, chars, init, p0: int, LS: int, out, next16=None) -> None:
    """Stage 1, routed by device (module docstring); ``next16`` is the
    kernel's shared-memory table (``PallasMatcher.next_table16``)."""
    if _on_cuda(cmap, next_tab, chars, init, out):
        _kernels().table_scan_cuda(cmap, next_tab, chars, init, p0, LS, out, next16=next16)
    else:
        scan_plain(cmap, next_tab, chars, init, p0, LS, out)


def scan_chunks_plain(cmap, next_tab, chars, init, p0: int, LS: int, C: int, W: int,
                      out) -> int:
    """The chunked form of the table scan kernel (``csrc/table_scan.cu``),
    vectorised over chunks with torch ops: the same states as
    ``scan_plain`` in ``out[:, p0:p0 + LS]``, for every DFA.  Returns the
    positions the repair phase overwrote.

    S1: the window is cut into chunks of ``C`` positions; each starts ``W``
    positions before its first one (at ``p0`` if that comes first: then it
    is exact) from the string's entry state ``init[d, b]``, walks the
    warm-up without storing, records its guess ``g`` (the state it reaches)
    and walks and stores its chunk, ending in ``e``.  S2: chunk by chunk,
    where chunk c - 1's true end differs from ``g[c]``, chunk c is walked
    again from that end, overwriting, until the walk meets the stored
    state (then the chunk's end is ``e[c]``) or the chunk ends (a new
    end)."""
    n_defs, _K, S = next_tab.shape
    dev = chars.device
    n_ch = -(-LS // C)
    cs = torch.arange(n_ch, device=dev) * C  # chunk starts, from p0
    ce = (cs + C).clamp(max=LS)
    ws = (cs - W).clamp(min=0)
    lead = cs - ws  # warm-up steps
    steps = int((ce - ws).max())
    repaired = 0
    for d in range(n_defs):
        off = (cmap[d].long()[chars[:, p0 : p0 + LS].long()] * S).t()  # [LS, B]
        flat = next_tab[d].reshape(-1).long()
        plane = out[d, p0 : p0 + LS]
        s = init[d].long()[None, :].expand(n_ch, -1).clone()
        g = s.clone()
        for t in range(steps):  # S1, all chunks at once
            pos = ws + t
            live = (pos < ce)[:, None]
            g = torch.where((lead == t)[:, None], s, g)
            s = torch.where(live, flat[off[pos.clamp(max=LS - 1)] + s], s)
            keep = (pos < ce) & (pos >= cs)  # the chunks storing this step
            plane[pos[keep]] = s[keep].to(torch.int32)
        e = s
        end = e[0]
        for c in range(1, n_ch):  # S2, chunk by chunk
            bad = end != g[c]
            if not bool(bad.any()):
                end = e[c]
                continue
            s = end.clone()
            for p in range(int(cs[c]), int(ce[c])):
                s_new = flat[off[p] + s]
                bad = bad & (s_new != plane[p].long())
                if not bool(bad.any()):
                    break
                plane[p] = torch.where(bad, s_new, plane[p].long()).to(torch.int32)
                repaired += int(bad.sum())
                s = torch.where(bad, s_new, s)
            end = torch.where(bad, s, e[c])
    return repaired


# ---------------------------------------------------------------------------
# Stage 2: tag (B9 / B11 tag on the card)
# ---------------------------------------------------------------------------


def tag_plain(states, prev, lengths, pairs, p0: int, LS: int, ids, start, endf) -> None:
    """Window [p0, p0 + LS) of the pair tagging: ``states`` [n_defs, L, B],
    ``prev`` [n_defs, B] (the states at p0 - 1: the first states, or the
    previous window's last row), ``lengths`` [B], ``pairs`` [n_defs, P, 5]
    -> ``ids``/``start``/``endf`` [n_defs, L, B] at the window, masked by
    pos < length."""
    nxt = states[:, p0 : p0 + LS]
    prv = torch.cat([prev[:, None, :], states[:, p0 : p0 + LS - 1]], 1)
    pos = torch.arange(p0, p0 + LS, dtype=torch.int32, device=states.device)
    en = (pos[:, None] < lengths[None, :]).to(torch.int32)
    for d, plist in enumerate(pairs.tolist()):
        i_ = torch.zeros_like(nxt[d])
        s_ = torch.zeros_like(nxt[d])
        e_ = torch.zeros_like(nxt[d])
        for a, b, gid, s_flag, e_flag in plist:
            if a < 0:
                continue
            m = ((prv[d] == a) & (nxt[d] == b)).to(torch.int32)
            i_ += gid * m
            if s_flag:
                s_ += m
            if e_flag:
                e_ += m
        ids[d, p0 : p0 + LS] = i_ * en
        start[d, p0 : p0 + LS] = s_ * en
        endf[d, p0 : p0 + LS] = e_ * en


def tag(states, prev, lengths, pairs, p0: int, LS: int, ids, start, endf) -> None:
    """Stage 2, routed by device (module docstring)."""
    if _on_cuda(states, prev, lengths, pairs, ids, start, endf):
        _kernels().table_tag_cuda(states, prev, lengths, pairs, p0, LS, ids, start, endf)
    else:
        tag_plain(states, prev, lengths, pairs, p0, LS, ids, start, endf)


# ---------------------------------------------------------------------------
# Stage 3: mask FSMs (B10 / B11 fsm on the card)
# ---------------------------------------------------------------------------


def _log_scan(a: torch.Tensor, b: torch.Tensor, reverse: bool):
    """Inclusive Hillis-Steele scan along dim 0 of the maps x' = a*x + b
    (the JAX ``_log_scan_pair_seg``): returns the composed (A, B)."""
    n = a.shape[0]
    shift = 1
    while shift < n:
        ones = torch.ones_like(a[:shift])
        zeros = torch.zeros_like(b[:shift])
        if not reverse:
            a_prev = torch.cat([ones, a[: n - shift]])
            b_prev = torch.cat([zeros, b[: n - shift]])
        else:
            a_prev = torch.cat([a[shift:], ones])
            b_prev = torch.cat([b[shift:], zeros])
        a, b = a_prev * a, a * b_prev + b
        shift *= 2
    return a, b


def fsm_plain(reverse: bool, ids, start, endf, entry, carry_ids, carry_x,
              p0: int, LS: int, out) -> None:
    """Window [p0, p0 + LS) of the forward (``reverse=False``) or backward
    mask FSM, written into ``out[p0:p0 + LS]`` ([L, B] int32).  The per-def
    ``ids``/``start``/``endf`` [n_defs, L, B] are summed over defs.

    Forward: ``entry`` [B] is the mask at p0 - 1, ``carry_ids`` and
    ``carry_x`` [n_defs, B] the ids and endf rows at p0 - 1.  Backward:
    ``entry`` is the mask at p0 + LS, ``carry_ids`` and ``carry_x`` the ids
    and start rows there.  ``None`` stands for zeros (the ends of L)."""
    sl = slice(p0, p0 + LS)
    i32 = torch.int32
    ids_sum = ids[:, sl].sum(0, dtype=i32)
    st_sum = start[:, sl].sum(0, dtype=i32)
    ef_sum = endf[:, sl].sum(0, dtype=i32)
    zero = torch.zeros_like(ids_sum[0])
    c_ids = zero if carry_ids is None else carry_ids.sum(0, dtype=i32)
    c_x = zero if carry_x is None else carry_x.sum(0, dtype=i32)
    e = zero if entry is None else entry
    if not reverse:
        prev_ids = torch.cat([c_ids[None], ids_sum[:-1]])
        prev_ef = torch.cat([c_x[None], ef_sum[:-1]])
        changed = prev_ids != ids_sum
        setp = (st_sum > 0) & changed
        reset = (st_sum == 0) & (prev_ef > 0) & changed
    else:
        next_ids = torch.cat([ids_sum[1:], c_ids[None]])
        next_st = torch.cat([st_sum[1:], c_x[None]])
        changed = next_ids != ids_sum
        setp = (ef_sum > 0) & changed
        reset = (ef_sum == 0) & (next_st > 0) & changed
    hold = (~setp & ~reset).to(i32)
    A, Bv = _log_scan(hold, setp.to(i32), reverse)
    out[sl] = A * e[None, :] + Bv


def fsms(ids, start, endf, p0: int, LS: int, fwd, bwd) -> None:
    """Stage 3, both FSMs over [p0, p0 + LS) with the null carries of the
    ends of L, routed by device (module docstring): on the card one call
    (``kernels.table_fsms_cuda``)."""
    if _on_cuda(ids, start, endf, fwd, bwd):
        _kernels().table_fsms_cuda(ids, start, endf, p0, LS, fwd, bwd)
    else:
        fsm_plain(False, ids, start, endf, None, None, None, p0, LS, fwd)
        fsm_plain(True, ids, start, endf, None, None, None, p0, LS, bwd)


def fsm_chunks_plain(ids, start, endf, fwd_carry, bwd_carry, p0: int, LS: int, CL: int,
                     fwd, bwd) -> None:
    """The chunked form of the FSM kernel (``csrc/table_fsm.cu``) in torch
    ops: both FSMs of ``fsm_plain`` over [p0, p0 + LS), written into
    ``fwd`` and ``bwd`` [L, B], each with its carries ``(entry, carry_ids,
    carry_x)`` (``None`` for zeros).  Each position's op is set (1), reset
    (0) or hold (-1).  A: each chunk of ``CL`` positions composes its maps
    -- forward, the last op that is not hold; backward, walked descending,
    the first.  B: the maps are chained in walk order from the entries
    (ascending forward, descending backward) into each chunk's carry-in.
    C: each chunk replays its positions from its carry-ins."""
    sl = slice(p0, p0 + LS)
    i32 = torch.int32
    I, St, E = (t[:, sl].sum(0, dtype=i32) for t in (ids, start, endf))
    B = I.shape[1]
    zero = torch.zeros_like(I[0])

    def sums(carry):
        entry, c_ids, c_x = carry
        return (zero if entry is None else entry,
                zero if c_ids is None else c_ids.sum(0, dtype=i32),
                zero if c_x is None else c_x.sum(0, dtype=i32))

    f_entry, f_ids, f_ef = sums(fwd_carry)
    b_entry, b_ids, b_st = sums(bwd_carry)

    def op(cur_ids, dec, nb_ids, nb_x):
        changed = nb_ids != cur_ids
        return torch.where(changed & (dec > 0), 1, torch.where(changed & (nb_x > 0), 0, -1))

    n_ch = -(-LS // CL)
    pad = n_ch * CL - LS
    hold = torch.full((pad, B), -1, dtype=torch.long, device=I.device)
    f_op = op(I, St, torch.cat([f_ids[None], I[:-1]]), torch.cat([f_ef[None], E[:-1]]))
    b_op = op(I, E, torch.cat([I[1:], b_ids[None]]), torch.cat([St[1:], b_st[None]]))
    f_op, b_op = (torch.cat([o.long(), hold]).reshape(n_ch, CL, B) for o in (f_op, b_op))
    j = torch.arange(CL, device=I.device)[None, :, None]
    # A: the last (forward) and first (backward) position of a chunk whose
    # op is not hold
    f_at = torch.where(f_op >= 0, j, -1)
    b_at = torch.where(b_op >= 0, j, CL)
    f_last = f_at.amax(1, keepdim=True)
    b_first = b_at.amin(1, keepdim=True)
    f_map = torch.where(f_last >= 0, f_op.gather(1, f_last.clamp(min=0)), -1)[:, 0]
    b_map = torch.where(b_first < CL, b_op.gather(1, b_first.clamp(max=CL - 1)), -1)[:, 0]
    # B: carry-ins in walk order
    f_in, b_in = torch.empty_like(f_map), torch.empty_like(b_map)
    x, y = f_entry.long(), b_entry.long()
    for c in range(n_ch):
        f_in[c], x = x, torch.where(f_map[c] >= 0, f_map[c], x)
        r = n_ch - 1 - c
        b_in[r], y = y, torch.where(b_map[r] >= 0, b_map[r], y)
    # C: each position takes the nearest op that is not hold at or before
    # it (forward) or at or after it (backward) in its chunk, else the
    # chunk's carry-in
    f_last = f_at.cummax(1).values
    b_next = b_at.flip(1).cummin(1).values.flip(1)
    xs = torch.where(f_last >= 0, f_op.gather(1, f_last.clamp(min=0)), f_in[:, None])
    ys = torch.where(b_next < CL, b_op.gather(1, b_next.clamp(max=CL - 1)), b_in[:, None])
    if fwd is not None:
        fwd[sl] = xs.reshape(-1, B)[:LS].to(i32)
    if bwd is not None:
        bwd[sl] = ys.reshape(-1, B)[:LS].to(i32)


def fsm_pass_plain(ids, start, endf, fwd_carry, bwd_carry, p0: int, LS: int, fwd, bwd,
                   codes=None) -> Optional[torch.Tensor]:
    """The one-pass form of the FSM kernel (``csrc/table_fsm.cu``) in torch
    ops, for tests (no pipeline calls it): both FSMs of ``fsm_plain`` over
    [p0, p0 + LS), written into ``fwd`` and ``bwd`` [L, B] (either may be
    ``None``), each with its carries ``(entry, carry_ids, carry_x)``
    (``None`` for zeros), computed as the kernel computes them.  The
    forward walk reads each position's sums once, runs the forward FSM and
    packs the backward op (0 hold, 1 set, 2 reset) of the position before
    it -- that op needs the ids and start of the next position, so it is
    known one step late, and the last one comes from the backward carry
    after the walk -- 2 bits a position, 16 positions a word: position
    p0 + 16 k + i at bits 2 i, 2 i + 1 of ``codes[k]`` ([ceil(LS / 16), B]
    int32; a new tensor when not given).  The backward walk then reads
    only the codes.  Returns the codes (None without ``bwd``)."""
    i32 = torch.int32
    B = ids.shape[2]
    dev = ids.device
    zero = torch.zeros(B, dtype=torch.long, device=dev)

    def sums(carry):
        entry, c_ids, c_x = carry
        return (zero if entry is None else entry.long(),
                zero if c_ids is None else c_ids.sum(0).long(),
                zero if c_x is None else c_x.sum(0).long())

    x, nb_ids, nb_x = sums(fwd_carry)
    if bwd is not None and codes is None:
        codes = torch.empty((-(-LS // 16), B), dtype=i32, device=dev)
    cw = zero
    for k in range(LS):
        p = p0 + k
        si, ss, se = (t[:, p].sum(0).long() for t in (ids, start, endf))
        changed = nb_ids != si
        if fwd is not None:
            x = torch.where(changed & (ss > 0), 1, torch.where(changed & (nb_x > 0), 0, x))
            fwd[p] = x.to(i32)
        if bwd is not None and k > 0:  # the backward op of position k - 1
            op = torch.where(changed & (nb_x > 0), 1, torch.where(changed & (ss > 0), 2, 0))
            cw = cw | op << 2 * ((k - 1) % 16)
            if (k - 1) % 16 == 15:
                codes[(k - 1) // 16], cw = _as_int32(cw), zero
        nb_ids, nb_x = si, se
    if bwd is None:
        return None
    y, c_ids, c_st = sums(bwd_carry)
    q = LS - 1
    op = torch.where(nb_ids != c_ids, torch.where(nb_x > 0, 1, torch.where(c_st > 0, 2, 0)), 0)
    codes[q // 16] = _as_int32(cw | op << 2 * (q % 16))
    for q in range(LS - 1, -1, -1):
        op = (codes[q // 16].long() >> 2 * (q % 16)) & 3
        y = torch.where(op == 1, 1, torch.where(op == 2, 0, y))
        bwd[p0 + q] = y.to(i32)
    return codes


# ---------------------------------------------------------------------------
# Monolithic mode: the flat stage (B12 on the card)
# ---------------------------------------------------------------------------


def pack_flat_table(tab: np.ndarray, S: int) -> np.ndarray:
    """[k, 4S] packed next | id | start | end rows (``build_packed_tables``,
    class-compressed or raw) -> [k, S] int32 entries
    ``next | id << 8 | start << 24 | endf << 25``."""
    t = tab.astype(np.int64)
    ent = (t[:, :S] | t[:, S : 2 * S] << FLAT_ID_SHIFT | t[:, 2 * S : 3 * S] << FLAT_START_SHIFT
           | t[:, 3 * S :] << FLAT_ENDF_SHIFT)
    return ent.astype(np.int32)


def flat_plain(cmap, table, first, chars, lengths, states, ids, start, endf, fwd, bwd) -> None:
    """The whole monolithic pipeline (the JAX ``_flat_kernel``): ``cmap``
    [n_defs, 256] and the packed ``table`` [n_defs, K, S] int32, ``first``
    [n_defs] int32, ``chars`` [B, L] uint8, ``lengths`` [B] int32 ->
    ``states``/``ids``/``start``/``endf`` [n_defs, L, B] and ``fwd``/``bwd``
    [L, B] int32, written in place.  The serial recurrence: per position,
    every def's entry (ids and flags masked by pos < length) and the forward
    FSM over the sums across defs; then the backward FSM, descending."""
    n_defs, _K, S = table.shape
    B, L = chars.shape
    dev = chars.device
    offs = [(cmap[d].long()[chars.long()] * S).t() for d in range(n_defs)]  # [L, B]
    flats = [table[d].reshape(-1).long() for d in range(n_defs)]
    s = [first[d].long().expand(B) for d in range(n_defs)]
    zero = torch.zeros(B, dtype=torch.long, device=dev)
    prev_ids, prev_ef, x = zero, zero, zero
    lens = lengths.long()
    sums = []
    for p in range(L):
        en = (p < lens).long()
        isum, ssum, esum = zero, zero, zero
        for d in range(n_defs):
            e = flats[d][offs[d][p] + s[d]]
            s[d] = e & 0xFF
            idv = (e >> FLAT_ID_SHIFT & 0xFFFF) * en
            stv = (e >> FLAT_START_SHIFT & 1) * en
            efv = (e >> FLAT_ENDF_SHIFT & 1) * en
            states[d, p], ids[d, p], start[d, p], endf[d, p] = s[d], idv, stv, efv
            isum, ssum, esum = isum + idv, ssum + stv, esum + efv
        changed = prev_ids != isum  # forward FSM (src/lib.rs:598-645)
        x = torch.where((ssum > 0) & changed, 1,
                        torch.where((ssum == 0) & (prev_ef > 0) & changed, 0, x))
        fwd[p] = x
        prev_ids, prev_ef = isum, esum
        sums.append((isum, ssum, esum))
    next_ids, next_st, y = zero, zero, zero
    for p in range(L - 1, -1, -1):  # backward FSM (src/lib.rs:663-714)
        isum, ssum, esum = sums[p]
        changed = next_ids != isum
        y = torch.where((esum > 0) & changed, 1,
                        torch.where((esum == 0) & (next_st > 0) & changed, 0, y))
        bwd[p] = y
        next_ids, next_st = isum, ssum


def flat_bits_plain(cmap, table, first, chars, lengths, states, ids, start, endf, fwd, bwd,
                    bits=None) -> torch.Tensor:
    """The flat kernel's passes in torch ops, for tests (no pipeline calls
    it): ``flat_plain``'s contract, computed as ``csrc/table_flat.cu``
    computes it.  The defs are scanned in groups of ``FLAT_GROUP_DEFS``;
    each group but the last parks its id sum and flags (the kernel's
    column in bwd), and the last completes them, runs the forward FSM and
    packs, 32 positions a word, the three bits the backward FSM reads --
    changed_p (position p's id sum against p + 1's, 0 past L: known one
    step later), start_any_p and endf_any_p -- into ``bits`` [3, ceil(L /
    32), B] int32 (bit p - 32 j of word j; a new tensor when not given).
    The backward FSM then reads only those words.  Returns ``bits``."""
    n_defs, _K, S = table.shape
    B, L = chars.shape
    dev = chars.device
    if bits is None:
        bits = torch.empty((3, -(-L // 32), B), dtype=torch.int32, device=dev)
    lens = lengths.long()
    zero = torch.zeros(B, dtype=torch.long, device=dev)
    park = None  # per position (id sum, start_any, endf_any) of the groups so far
    for g0 in range(0, n_defs, FLAT_GROUP_DEFS):
        defs = range(g0, min(g0 + FLAT_GROUP_DEFS, n_defs))
        last = g0 + FLAT_GROUP_DEFS >= n_defs
        offs = {d: (cmap[d].long()[chars.long()] * S).t() for d in defs}  # [L, B]
        flats = {d: table[d].reshape(-1).long() for d in defs}
        s = {d: first[d].long().expand(B) for d in defs}
        prev_ids, prev_ef, x = zero, zero.bool(), zero
        ch_w, st_w, ef_w = zero, zero, zero  # the bit words being filled
        parked = []
        for p in range(L):
            en = (p < lens).long()
            isum, st_any, ef_any = zero, zero.bool(), zero.bool()
            for d in defs:
                e = flats[d][offs[d][p] + s[d]]
                s[d] = e & 0xFF
                idv = (e >> FLAT_ID_SHIFT & 0xFFFF) * en
                stv = (e >> FLAT_START_SHIFT & 1) * en
                efv = (e >> FLAT_ENDF_SHIFT & 1) * en
                states[d, p], ids[d, p], start[d, p], endf[d, p] = s[d], idv, stv, efv
                isum, st_any, ef_any = isum + idv, st_any | (stv > 0), ef_any | (efv > 0)
            if park is not None:
                isum, st_any, ef_any = (isum + park[p][0], st_any | park[p][1],
                                        ef_any | park[p][2])
            if not last:
                parked.append((isum, st_any, ef_any))
                continue
            changed = prev_ids != isum  # forward FSM (src/lib.rs:598-645)
            x = torch.where(st_any & changed, 1, torch.where(~st_any & prev_ef & changed, 0, x))
            fwd[p] = x
            if p > 0:  # changed is position p - 1's backward bit
                r = (p - 1) % 32
                ch_w = ch_w | changed.long() << r
                if r == 31:
                    bits[0, (p - 1) // 32], ch_w = _as_int32(ch_w), zero
            r = p % 32
            st_w, ef_w = st_w | st_any.long() << r, ef_w | ef_any.long() << r
            if r == 31:
                bits[1, p // 32], bits[2, p // 32], st_w, ef_w = (
                    _as_int32(st_w), _as_int32(ef_w), zero, zero)
            prev_ids, prev_ef = isum, ef_any
        if last and L:  # position L - 1's changed bit (no sum past L) and the partial words
            p, r = L - 1, (L - 1) % 32
            bits[0, p // 32] = _as_int32(ch_w | (prev_ids != 0).long() << r)
            if r != 31:
                bits[1, p // 32], bits[2, p // 32] = _as_int32(st_w), _as_int32(ef_w)
        park = parked
    y, next_st = zero, zero.bool()
    for j in range(-(-L // 32) - 1, -1, -1):  # backward FSM (src/lib.rs:663-714)
        cw, sw, ew = (bits[k, j].long() & 0xFFFFFFFF for k in range(3))
        for k in range(min(32, L - 32 * j) - 1, -1, -1):
            changed, ef_any = (cw >> k & 1) > 0, (ew >> k & 1) > 0
            y = torch.where(ef_any & changed, 1, torch.where(~ef_any & next_st & changed, 0, y))
            bwd[32 * j + k] = y
            next_st = (sw >> k & 1) > 0
    return bits


def flat(cmap, table, first, chars, lengths, states, ids, start, endf, fwd, bwd) -> None:
    """The flat stage, routed by device (module docstring)."""
    args = (cmap, table, first, chars, lengths, states, ids, start, endf, fwd, bwd)
    if _on_cuda(*args):
        _kernels().table_flat_cuda(*args)
    else:
        flat_plain(*args)


# ---------------------------------------------------------------------------
# The finish (torch ops, shared with the portable scan)
# ---------------------------------------------------------------------------


def finish_planes(first, dummy, dead, accept_mask, chars, lengths, states_tm, ids_tm, start_tm,
                  endf_tm, fwd_tm, bwd_tm) -> RegexResult:
    """The JAX ``_core`` tail (halo2_regex_tpu/ops/pallas_scan.py:1405),
    the same as the tail of ``_match_core`` (ops/scan_jax.py:117-218):
    the dummy state past each length, the final state read at the length,
    the sums over defs and the mask, with the JAX values and dtypes.
    ``first``, ``dummy``, ``dead`` [n_defs] int32 and ``accept_mask``
    [n_defs, S] bool are the model's constants; the planes are time-major
    (states, ids, start, endf [n_defs, L, B] and fwd, bwd [L, B], int32),
    with ids, start and endf already masked by the enable, so start_enable
    and end_enable are the start and endf planes themselves.  The columns
    are computed time-major and returned as [B, ...] views of those
    buffers."""
    B, L = chars.shape
    n_defs, dev, i32 = first.shape[0], chars.device, torch.int32
    pos = torch.arange(L + 1, dtype=i32, device=dev)
    enable = (pos[None, :L] < lengths[:, None]).to(i32)  # [B, L]
    chars_i32 = chars.to(i32) * enable
    raw = torch.empty((n_defs, L + 1, B), dtype=i32, device=dev)
    raw[:, 0] = first[:, None]
    raw[:, 1:] = states_tm
    in_range = pos[:, None] <= lengths[None, :]  # [L + 1, B]
    states = torch.where(in_range, raw, dummy[:, None, None])
    idx = lengths.long()[None, None, :].expand(n_defs, 1, B)
    final = torch.gather(raw, 1, idx)[:, 0].t()  # [B, n_defs]
    accepted = accept_mask[torch.arange(n_defs, device=dev)[None, :], final.long()]
    has_dead = final == dead[None, :]
    ids_sum = ids_tm.sum(0, dtype=i32)  # [L, B]
    mask = fwd_tm * bwd_tm
    start_sum = torch.zeros((L + 1, B), dtype=i32, device=dev)
    start_sum[:L] = start_tm.sum(0, dtype=i32)
    end_sum = torch.zeros((L + 1, B), dtype=i32, device=dev)
    end_sum[1:] = endf_tm.sum(0, dtype=i32)
    return RegexResult(
        all_enable_flags=enable,
        all_characters=chars_i32,
        all_substr_ids=(mask * ids_sum).t(),
        masked_characters=mask.t() * chars_i32,
        states=states.permute(2, 0, 1),
        substr_ids_per_def=ids_tm.permute(2, 0, 1),
        start_enable=start_tm.permute(2, 0, 1),
        end_enable=endf_tm.permute(2, 0, 1),
        is_start_sum=start_sum.t(),
        is_end_sum=end_sum.t(),
        substr_id_sum=ids_sum.t(),
        fwd_mask=fwd_tm.t(),
        bwd_mask=bwd_tm.t(),
        mask=mask.t(),
        accepted=accepted,
        has_dead=has_dead,
        match_ok=accepted.all(1) & ~has_dead.any(1),
    )


# ---------------------------------------------------------------------------
# The matcher
# ---------------------------------------------------------------------------


class PallasMatcher(nn.Module):
    """Table-driven matcher (port of the JAX ``PallasMatcher``, split and
    monolithic modes); a call returns a ``RegexResult`` equal to the JAX
    matcher's, dtypes included.

    Args mirror the JAX constructor, less ``interpret``, plus ``device``
    (``"cuda"``, the default, runs the CUDA kernels and raises where CUDA is
    absent; ``"cpu"`` runs their plain versions).  ``batch_tile`` only
    feeds the segmented demotion, as in JAX: the port does not pad the
    batch.  ``H2R_VMEM_BUDGET`` and ``H2R_SEGMENT`` are read as in JAX, so
    ``mode``, ``grid_mode``, ``segment`` and ``n_seg`` equal the JAX
    matcher's for the same model; the plain pipeline runs those windows,
    the card ignores them (one pass over [0, L)).  Monolithic mode ignores
    ``grid_mode`` and runs the whole L in one flat launch, as in JAX.  ``chunk`` and
    ``slab`` block the TPU kernels: any value JAX takes is taken, and
    ``chunk``, ``slab``, ``n_slab``, ``slab_seg`` and ``scan_stride`` are
    sized from them as JAX sizes them, but the port's kernels run the
    same windows whatever they are.  ``compute`` ("mxu"/"vpu"),
    ``table_dtype`` ("bf16"/"int8") and ``extract``
    ("select"/"take_along") pick TPU lowerings of one gather; the port
    gathers directly, keeps each as an attribute and computes the same
    outputs for every value.  Every model the constructor builds runs on
    the card: the tag kernel reads pair lists beyond its shared-memory
    stage from global memory, and the flat kernel runs more than 8 defs
    in groups of 8.
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        batch_tile: int = 0,
        chunk: int = 256,
        max_boundary_terms: int = 96,
        extract: str = "select",
        grid_mode: str = "batch",
        slab: int = 8,
        compute: str = "mxu",
        mode: str = "auto",
        max_pairs: int = 160,
        table_dtype: str = "bf16",
        device="cuda",
    ):
        super().__init__()
        if grid_mode == "chunked":
            raise ValueError(
                "grid_mode='chunked' was removed from the JAX package (Mosaic "
                "SIGABRT); use 'segmented'"
            )
        if grid_mode not in ("batch", "segmented"):
            raise ValueError(f"grid_mode={grid_mode!r}: expected batch/segmented")
        self.model = model
        # the TPU lowerings of the table gather, kept as JAX keeps them
        self.extract = extract
        self.compute = compute
        self.table_dtype = table_dtype
        L = self.L = model.max_chars_size
        self.S = model.s_pad
        self.n_defs = model.n_defs
        self.grid_mode = grid_mode
        if grid_mode == "batch":  # the JAX constructor's chunk sizing
            chunk = L
        LC = min(chunk, L)
        while L % LC != 0:
            LC //= 2
        self.chunk = LC
        self._budget = int(float(os.environ.get("H2R_VMEM_BUDGET", 56e6)))
        mode = self._build_tables(mode, max_boundary_terms)
        self._resolve_mode(mode, max_pairs)
        self._size_tiles(batch_tile, slab)
        self._register_tables()
        self.to(resolve_device(device))

    # ------------------------------------------------- construction phases

    def _build_tables(self, mode: str, max_boundary_terms: int) -> str:
        """Byte-class compression per def, as the JAX ``_build_tables``:
        sets ``hi_lo``, ``class_info`` (use_classes, cls0, terms, table) and
        the port's tables ``_cmap`` [n_defs, 256], ``_next``
        [n_defs, K, S] and, for models of at most 256 states, the flat
        stage's packed ``_flat`` [n_defs, K, S] (K: the widest def's class
        count, 256 for a def that keeps raw bytes, rounded up to 8)."""
        model = self.model
        S = self.S
        n_defs = self.n_defs
        hi_lo = S > 256
        self.hi_lo = hi_lo
        if hi_lo:
            assert model.total_substrs <= 256, "substr ids > 256 unsupported"
            if mode == "monolithic":
                raise ValueError(">256-state models need mode='split'")
            mode = "split"
            packed = None
        else:
            packed = build_packed_tables(model)
        class_info, class_ofs = [], []
        for d in range(n_defs):
            if hi_lo:
                class_of, ctab_next = byte_classes(model.transition[d].astype(np.float32))
                ctab_next = ctab_next.astype(np.int64)
                tab = np.concatenate([ctab_next & 0xFF, ctab_next >> 8], axis=1)
                tab = tab.astype(np.float32)
            else:
                class_of, tab = byte_classes(packed[d])
            cls0, terms = class_boundaries(class_of)
            class_info.append((len(terms) <= max_boundary_terms, cls0, terms, tab))
            class_ofs.append(class_of)
        self.class_info = class_info
        k_rows = max(ci[3].shape[0] if ci[0] else 256 for ci in class_info)
        K = _round_up(max(k_rows, 8), 8)
        cmap = np.zeros((n_defs, 256), np.int32)
        nxt = np.zeros((n_defs, K, S), np.int32)
        flat = None if hi_lo else np.zeros((n_defs, K, S), np.int32)
        for d, (use_classes, _cls0, _terms, tab) in enumerate(class_info):
            if use_classes:
                cmap[d] = class_ofs[d]
                t = tab.astype(np.int64)
                rows = t[:, :S] + 256 * t[:, S : 2 * S] if hi_lo else t[:, :S]
                nxt[d, : tab.shape[0]] = rows
            else:  # raw bytes: the identity map over the transition table
                cmap[d] = np.arange(256)
                nxt[d, :256] = model.transition[d]
                tab = None if hi_lo else packed[d]
            if flat is not None:
                flat[d, : tab.shape[0]] = pack_flat_table(tab, S)
        self._cmap, self._next, self._flat = cmap, nxt, flat
        return mode

    def _resolve_mode(self, mode: str, max_pairs: int) -> None:
        """Valid (prev, next) pairs per def, and split vs monolithic, as
        the JAX ``_resolve_mode``; sets ``pair_info`` and the padded pair
        array ``_pairs`` [n_defs, P, 5] (P: the longest def's list)."""
        pair_info = [_substr_pairs(self.model, d) for d in range(self.n_defs)]
        split_ok = all(len(plist) <= max_pairs for plist in pair_info)
        if mode == "auto":
            mode = "split" if split_ok else "monolithic"
        elif mode == "split" and not split_ok:
            raise ValueError(f"split mode needs <= {max_pairs} valid pairs per def")
        self.mode = mode
        self.pair_info = pair_info
        P = max(len(p) for p in pair_info)
        pairs = np.zeros((self.n_defs, P, PAIR_FIELDS), np.int32)
        pairs[:, :, 0] = -1
        for d, plist in enumerate(pair_info):
            if plist:
                pairs[d, : len(plist)] = np.array(plist, np.int64)
        self._pairs = pairs

    def _size_tiles(self, batch_tile: int, slab: int) -> None:
        """The JAX ``_size_tiles`` sizing: the batch tile as far as the
        segmented demotion reads it, the scan stride, ``slab`` and
        ``n_slab``, then ``segment`` (``H2R_SEGMENT``, halved until it
        divides L), ``slab_seg`` and ``n_seg``.  Only the demotion and the
        segments change what the port runs; the rest block the TPU kernels
        and are kept as JAX exposes them."""
        L = self.L
        n_defs = self.n_defs
        split_blocks = max(n_defs + 1, 4 * n_defs, 3 * n_defs + 2)
        if not batch_tile:
            blocks = split_blocks if self.mode == "split" else 4 * n_defs + 3
            per_tb = 2 * L * 4 * blocks
            batch_tile = max(128, min(1024, (self._budget // per_tb) // 128 * 128))
        self.batch_tile = batch_tile
        if (self.mode == "split" and self.grid_mode == "batch"
                and 2 * L * 4 * split_blocks * batch_tile > self._budget):
            self.grid_mode = "segmented"
        # stride-2 scanning composes byte pairs of at most 16 classes
        # (k^2 <= 256) in batch-mode split scans
        stride = 1
        if self.mode == "split" and not self.hi_lo and self.grid_mode == "batch":
            stride = 2 if all(use and tab.shape[0] ** 2 <= 256
                              for use, _c0, _t, tab in self.class_info) and L % 2 == 0 else 1
        SLAB = min(slab, L)
        while L % SLAB != 0:
            SLAB //= 2
        self.n_slab = L // SLAB
        self.slab = SLAB
        if stride == 2 and L % (2 * SLAB) != 0:
            stride = 1
        self.scan_stride = stride
        LS = min(int(os.environ.get("H2R_SEGMENT", 4096)), L)
        while L % LS != 0:
            LS //= 2
        SLAB_SEG = SLAB
        while LS % SLAB_SEG != 0:
            SLAB_SEG //= 2
        self.segment = LS
        self.slab_seg = SLAB_SEG
        self.n_seg = L // LS

    def _register_tables(self) -> None:
        model = self.model
        self.register_buffer("class_map", torch.from_numpy(self._cmap))
        self.register_buffer("next_table", torch.from_numpy(self._next))
        # the scan kernel's shared-memory table, 2 * next (a state's byte
        # offset in a row) as uint16 bits in int16: made once here rather
        # than by every launch
        self.register_buffer("next_table16", torch.from_numpy(
            (2 * self._next).astype(np.uint16).view(np.int16)) if self.S <= 32768 else None)
        self.register_buffer("pairs", torch.from_numpy(self._pairs))
        self.register_buffer(
            "flat_table", torch.from_numpy(self._flat) if self.mode == "monolithic" else None)
        self.register_buffer("accept_mask", torch.from_numpy(np.asarray(model.accept_mask, bool)))
        for name in ("accepted_states", "dummy_states", "dead_states", "first_states"):
            self.register_buffer(
                name, torch.from_numpy(np.asarray(getattr(model, name), np.int32))
            )

    @property
    def device(self) -> torch.device:
        return self.accept_mask.device

    @property
    def window(self) -> int:
        """Positions per window of the plain pipeline: ``segment`` when
        segmented, else L.  ``segment``, ``n_seg`` and this keep the JAX
        matcher's values (its VMEM budget); the card ignores them and runs
        each stage once over [0, L) (``run_planes``)."""
        return self.segment if self.grid_mode == "segmented" else self.L

    # ----------------------------------------------------------- pipeline

    def _firsts(self, B: int) -> torch.Tensor:
        return self.first_states[:, None].expand(self.n_defs, B).contiguous()

    def _scan_all(self, chars, init, states, plain: bool) -> None:
        """The scan from ``init``: on the card one pass over [0, L), else
        ``scan_plain`` window by window."""
        if not plain and _on_cuda(chars, init, states):
            scan(self.class_map, self.next_table, chars, init, 0, self.L, states,
                 next16=self.next_table16)
            return
        LS = self.window
        for p0 in range(0, self.L, LS):
            scan_plain(self.class_map, self.next_table, chars, init, p0, LS, states)
            init = states[:, p0 + LS - 1]

    def run(self, chars: torch.Tensor, lengths: torch.Tensor, plain: bool = False) -> RegexResult:
        """The split pipeline on ``chars`` [B, L] uint8 and ``lengths`` [B]
        int32 (both on the matcher's device), then the finish.  ``plain``
        runs the plain version of every stage on any device (the reference
        the kernels are held against)."""
        return self.finish(chars, lengths, *self.run_planes(chars, lengths, plain))

    def run_planes(self, chars: torch.Tensor, lengths: torch.Tensor, plain: bool = False):
        """Split mode: the three stages -- every scan, then every tag, the
        forward FSM ascending and the backward FSM descending.  On the card
        each runs once over [0, L), with the null carries of a first window
        (the scan and both FSMs in their chunked forms where the batch
        leaves the card idle: ``kernels.table_scan_form``,
        ``table_fsm_form``); the plain pipeline (``plain``, or the CPU)
        runs them over ``window``-position windows with carries (the JAX
        ``_run_segmented``; batch mode is one window).  Monolithic mode:
        one flat stage.  Returns the time-major planes states, ids, start,
        endf [n_defs, L, B] and fwd, bwd [L, B], all int32."""
        B, L = chars.shape
        if L != self.L:
            raise ValueError(f"chars are [B, {L}]; the model needs L={self.L}")
        if tuple(lengths.shape) != (B,):
            raise ValueError(f"lengths {tuple(lengths.shape)}: expected ({B},)")
        n_defs, dev = self.n_defs, chars.device

        def plane(*lead):
            return torch.empty((*lead, L, B), dtype=torch.int32, device=dev)

        if self.mode == "monolithic":
            outs = [plane(n_defs) for _ in range(4)] + [plane(), plane()]
            (flat_plain if plain else flat)(self.class_map, self.flat_table, self.first_states,
                                           chars, lengths, *outs)
            return tuple(outs)
        card = not plain and _on_cuda(chars, lengths)
        firsts = self._firsts(B)
        states = plane(n_defs)
        self._scan_all(chars, firsts, states, plain)
        ids, start, endf = plane(n_defs), plane(n_defs), plane(n_defs)
        fwd, bwd = plane(), plane()
        if card:
            tag(states, firsts, lengths, self.pairs, 0, L, ids, start, endf)
            fsms(ids, start, endf, 0, L, fwd, bwd)
            return states, ids, start, endf, fwd, bwd
        LS = self.window
        prev = firsts
        for p0 in range(0, L, LS):
            tag_plain(states, prev, lengths, self.pairs, p0, LS, ids, start, endf)
            prev = states[:, p0 + LS - 1]
        entry = c_ids = c_x = None
        for p0 in range(0, L, LS):
            fsm_plain(False, ids, start, endf, entry, c_ids, c_x, p0, LS, fwd)
            q = p0 + LS - 1
            entry, c_ids, c_x = fwd[q], ids[:, q], endf[:, q]
        entry = c_ids = c_x = None
        for p0 in range(L - LS, -1, -LS):
            fsm_plain(True, ids, start, endf, entry, c_ids, c_x, p0, LS, bwd)
            entry, c_ids, c_x = bwd[p0], ids[:, p0], start[:, p0]
        return states, ids, start, endf, fwd, bwd

    def finish(self, chars, lengths, states_tm, ids_tm, start_tm, endf_tm, fwd_tm, bwd_tm):
        """The JAX ``_core`` tail (halo2_regex_tpu/ops/pallas_scan.py:1405)
        on this model's constants: ``finish_planes``."""
        return finish_planes(self.first_states, self.dummy_states, self.dead_states,
                             self.accept_mask, chars, lengths, states_tm, ids_tm, start_tm,
                             endf_tm, fwd_tm, bwd_tm)

    @torch.no_grad()
    def forward(self, chars, lengths) -> RegexResult:
        chars = torch.as_tensor(chars, dtype=torch.uint8, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return self.run(chars.contiguous(), lengths.contiguous())

    def match_one(self, characters: bytes) -> RegexResult:
        buf = np.zeros((1, self.L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        res = self(buf, np.array([len(characters)], np.int32))
        return res.map(lambda v: v[0].cpu().numpy())

    @torch.no_grad()
    def scan_states_tm(self, ctm, init, B: int) -> torch.Tensor:
        """Per-position states [n_defs, L, B] int32 scanned from per-string
        initial states ``init`` [n_defs, B] instead of the model's first
        states: the per-shard hook of sequence-sharded and speculative
        scanning.  ``ctm`` is the time-major [L, B] int32 character array of
        the JAX signature.  Needs ``grid_mode="segmented"``, as in JAX."""
        if self.grid_mode != "segmented":
            raise ValueError(
                f"scan_states_tm needs grid_mode='segmented' (got {self.grid_mode!r})"
            )
        ctm = torch.as_tensor(ctm, device=self.device)
        if tuple(ctm.shape) != (self.L, B):
            raise ValueError(f"ctm {tuple(ctm.shape)}: expected ({self.L}, {B})")
        chars = ctm.t().to(torch.uint8).contiguous()
        init = torch.as_tensor(init, dtype=torch.int32, device=self.device).contiguous()
        states = torch.empty((self.n_defs, self.L, B), dtype=torch.int32, device=self.device)
        self._scan_all(chars, init, states, plain=False)
        return states
