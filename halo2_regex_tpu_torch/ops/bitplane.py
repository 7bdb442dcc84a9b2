"""Bit-sliced (bitplane) witness pipeline, PyTorch port.

The port of ``halo2_regex_tpu.ops.bitplane.BitplaneMatcher(columns=
"witness")`` with the default knobs.  Thirty-two strings share each int32
word and the DFA runs as synthesized boolean circuits
(:mod:`..compiler.bitslice`):

  1. **qpack**: [B, L] bytes -> 8 byte-bit planes -> each def's byte->class
     circuit -> class planes [L, KP, NWS, LANE], plus the enable plane
     (pos < len) [NWS, L, LANE].
  2. **scan**: the only sequential stage.  One-hot live-state planes are
     carried across the bytes; each byte runs every def's step circuit and
     writes log2-encoded state planes [NWS, SB, L, LANE].
  3. **post**: tag circuit on (prev, next) state planes, id sum across
     defs, forward/backward mask FSMs, dummy splice, and an 8x8 bit
     transpose into byte-group words [NWS, 8G, L, LANE], plus the
     final-state boundary planes ``fb`` [NWS, n_defs, 8, LANE].
  4. **decode + finish** (plain torch ops): byte-group words -> [B, L]
     uint8 columns, final states from ``fb``, verdicts.

The packed layout is the JAX package's exactly, so every intermediate can
be compared array for array: word ``w`` of a plane holds, at bit
``beta``, string ``g(w, beta) = 4*(w + NW*(beta % 8)) + beta // 8``
(NW = B/32), and planes are NWS-major with LANE = 128 words per row.

Each stage has a plain PyTorch version here (``qpack_plain``,
``scan_plain``, ``post_plain``) and a hand-written CUDA kernel in
``csrc/`` (bound by :mod:`.kernels`).  The stage functions ``qpack``,
``scan`` and ``post`` route by device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (or raises).  There is no
fallback between the two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..compiler.bitslice import DefCircuits, synthesize_def
from ..models.compiled import CompiledRegexModel
from .knobs import check_main_path

LANE = 128
TILE = 32 * LANE  # strings per NWS row: the batch is padded to a multiple
_QUAD_MASK = 0x01010101


def _substr_pairs(model: CompiledRegexModel, d: int):
    nz = np.argwhere(model.substr_id_table[d] > 0)
    out = []
    for a, b in nz:
        gid = int(model.substr_id_table[d][a, b])
        out.append(
            (
                int(a),
                int(b),
                gid,
                bool(model.is_start_table[gid, a]),
                bool(model.is_end_table[gid, b]),
            )
        )
    return out


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# The plan: everything static about one matcher
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)  # hashed by identity: kernels.build keys on it
class BitplanePlan:
    """Model-derived layout shared by the kernels and their plain versions.

    ``cls_off[d]``/``sb_off[d]``: def d's first class plane / log plane in
    the concatenated stacks.  ``wgroups``: the byte groups of the post
    emission, each a tuple of (field, first bit, bit count) with at most 8
    bits in all (``flags`` = mask, fwd, bwd, en, start_any, endf_any)."""

    circuits: Tuple[DefCircuits, ...]
    L: int
    idb: int
    nsum: int
    cls_off: Tuple[int, ...]
    kp: int
    sb_off: Tuple[int, ...]
    sb_sum: int
    wgroups: Tuple[Tuple[Tuple[str, int, int], ...], ...]
    first_states: Tuple[int, ...]
    dummy_states: Tuple[int, ...]

    @property
    def n_defs(self) -> int:
        return len(self.circuits)

    @property
    def n_groups(self) -> int:
        return len(self.wgroups)

    def first_bit(self, d: int, j: int) -> bool:
        return bool((self.first_states[d] >> j) & 1)


def make_plan(model: CompiledRegexModel) -> BitplanePlan:
    """Synthesize every def's circuits (binary class stage) and lay out
    the plane stacks and byte groups as the JAX matcher does."""
    n_defs = model.n_defs
    L = model.max_chars_size
    if L > LANE and L % LANE:
        raise NotImplementedError(
            f"max_chars_size={L}: L > {LANE} must be a multiple of {LANE}. "
            "The JAX matcher pads such L and packs through the raw-quads "
            "pack kernel (B5), which waits for ROADMAP A5"
        )
    idb = max(1, int(model.total_substrs).bit_length())
    circuits = []
    for d in range(n_defs):
        c = synthesize_def(
            model.transition[d],
            int(model.first_states[d]),
            int(model.dead_states[d]),
            _substr_pairs(model, d),
            idb=idb,
            fold_class=False,
            class_encoding="binary",
        )
        circuits.append(c)
    cls_off, sb_off = [], []
    off_c = off_sb = 0
    for c in circuits:
        cls_off.append(off_c)
        off_c += len(c.class_plane_names)
        sb_off.append(off_sb)
        off_sb += c.sb
    nsum = idb if n_defs == 1 else idb + (n_defs - 1).bit_length() + 1
    fields = [("flags", 6), ("masked_idsum", nsum)]
    fields += [(f"states{d}", c.sb) for d, c in enumerate(circuits)]
    if any(nb > 8 for _, nb in fields):
        raise NotImplementedError(
            f"fields {fields}: a field wider than 8 bits needs the planes "
            "emission, which waits for ROADMAP A11"
        )
    groups: List[Tuple[Tuple[str, int, int], ...]] = []
    cur: List[Tuple[str, int, int]] = []
    bits = 0
    for name, nb in fields:
        if bits + nb > 8:
            groups.append(tuple(cur))
            cur, bits = [], 0
        cur.append((name, bits, nb))
        bits += nb
    if cur:
        groups.append(tuple(cur))
    # The post stage splices each def's dummy state into its log planes
    # where enable is off.  dummy = largest + 1 < dead, and dead is a live
    # state, so the dummy always fits the def's sb planes.
    for d, c in enumerate(circuits):
        if int(model.dummy_states[d]).bit_length() > c.sb:
            raise ValueError(f"def {d}: dummy state does not fit {c.sb} planes")
    return BitplanePlan(
        circuits=tuple(circuits),
        L=L,
        idb=idb,
        nsum=nsum,
        cls_off=tuple(cls_off),
        kp=off_c,
        sb_off=tuple(sb_off),
        sb_sum=off_sb,
        wgroups=tuple(groups),
        first_states=tuple(int(s) for s in model.first_states),
        dummy_states=tuple(int(s) for s in model.dummy_states),
    )


# ---------------------------------------------------------------------------
# Packed-domain helpers (plain torch, position-parallel)
# ---------------------------------------------------------------------------


def len_table(lengths: torch.Tensor) -> torch.Tensor:
    """[B] lengths -> per-word table [NWS, LANE, 32]: entry (w, beta) is the
    length of string g(w, beta) (lengths viewed (m, w, s), reordered to
    (w, s, m) so beta = 8s + m)."""
    B = lengths.shape[0]
    NW = B // 32
    return (
        lengths.reshape(8, NW, 4).permute(1, 2, 0).reshape(NW // LANE, LANE, 32)
        .contiguous()
    )


def transpose8_planes(planes: List[torch.Tensor]) -> List[torch.Tensor]:
    """SWAR 8x8 bit-block transpose of eight int32 planes: output word
    ``O_b`` holds, in byte lane ``s`` bit ``j``, the bit ``P_j[8s+b]``, i.e.
    the value bytes of the four strings at ``beta % 8 == b``.  The masks
    make arithmetic right shifts safe (sign bits are masked off)."""
    x = list(planes)
    assert len(x) == 8
    for d, mask in ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        for i in range(8):
            if i & d:
                continue
            a, b = x[i], x[i + d]
            t = ((a >> d) ^ b) & mask
            x[i + d] = b ^ t
            x[i] = a ^ (t << d)
    return x


def plane_add(a: List[torch.Tensor], b: List[torch.Tensor], n_out: int):
    """Bit-sliced ripple-carry add of two plane vectors (LSB first)."""
    out = []
    carry = None
    for j in range(n_out):
        x = a[j] if j < len(a) else None
        y = b[j] if j < len(b) else None
        terms = [t for t in (x, y, carry) if t is not None]
        if not terms:
            out.append(torch.zeros_like(a[0]))
            continue
        s = terms[0]
        c = None
        for t in terms[1:]:
            new_c = s & t
            s = s ^ t
            c = new_c if c is None else (c | new_c)
        out.append(s)
        carry = c
    return out


def _fsm_log_scan(hold: torch.Tensor, setp: torch.Tensor, reverse: bool):
    """Inclusive scan along dim 1 of the 1-bit affine maps
    x' = hold·x + set, applied to initial state 0 (Hillis-Steele: log2(L)
    rounds of compose-with-shifted-self).  Reference FSM semantics:
    src/lib.rs:598-714."""
    L = hold.shape[1]
    a, b = hold, setp
    shift = 1
    while shift < L:
        pad = list(a.shape)
        pad[1] = shift
        ones = torch.full(pad, -1, dtype=a.dtype, device=a.device)
        zeros = torch.zeros(pad, dtype=b.dtype, device=b.device)
        if not reverse:
            a_prev = torch.cat([ones, a[:, : L - shift]], 1)
            b_prev = torch.cat([zeros, b[:, : L - shift]], 1)
        else:
            a_prev = torch.cat([a[:, shift:], ones], 1)
            b_prev = torch.cat([b[:, shift:], zeros], 1)
        a, b = a_prev & a, (a & b_prev) | b
        shift *= 2
    return b


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction over ``dim`` (pairwise tree)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        y = x[:half] | x[half : 2 * half]
        if x.shape[0] % 2:
            y = torch.cat([y, x[2 * half :]], 0)
        x = y
    return x[0]


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """Route a stage: False for CPU tensors (plain version), True for CUDA
    tensors (kernel).  Anything else, or a mix, raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"device {dev}: the port runs on cpu (plain) or cuda")


# ---------------------------------------------------------------------------
# Stage 1: qpack (K1 on the card)
# ---------------------------------------------------------------------------


def qpack_plain(
    plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] uint8 chars and the [NWS, LANE, 32] length table -> class
    planes [L, KP, NWS, LANE] and enable plane [NWS, L, LANE]
    (int32).  Same function as the JAX ``_make_qpack`` kernel."""
    B, L = chars.shape
    NW = B // 32
    NWS = NW // LANE
    # string g = m*4NW + 4w + s: the pure view [8m, NW, 4s, L]
    ch = chars.reshape(8, NW, 4, L).to(torch.int32)
    word = ch[:, :, 0]
    for s in range(1, 4):
        word = word | (ch[:, :, s] << (8 * s))  # [8m, NW, L] quad words
    planes = []
    for j in range(8):
        acc = None
        for m in range(8):
            v = ((word[m] >> j) & _QUAD_MASK) << m
            acc = v if acc is None else acc | v
        planes.append(acc.t().reshape(L, NWS, LANE))
    env = {f"byte_bit{j}": planes[j] for j in range(8)}
    cls = []
    for c in plan.circuits:
        out = c.class_prog.run(env)
        cls += [out[name] for name in c.class_plane_names]
    bits_stack = torch.stack(cls, 1).contiguous()
    pos = torch.arange(L, dtype=torch.int32, device=chars.device)
    en = torch.zeros((NWS, L, LANE), dtype=torch.int32,
                     device=chars.device)
    for beta in range(32):
        lt = pos[None, :, None] < len_wb[:, None, :, beta]
        en |= lt.to(torch.int32) << beta
    return bits_stack, en


def qpack(plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor):
    """Stage 1, routed by device (see module docstring)."""
    if _on_cuda(chars, len_wb):
        from . import kernels

        return kernels.qpack_cuda(plan, chars, len_wb)
    return qpack_plain(plan, chars, len_wb)


# ---------------------------------------------------------------------------
# Stage 2: scan (K2 on the card)
# ---------------------------------------------------------------------------


def scan_plain(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """Class planes [L, KP, NWS, LANE] -> log state planes
    [NWS, SB, L, LANE]: the serial recurrence of the JAX
    ``_make_scan_fused`` kernel, one byte position per Python step."""
    L, _kp, NWS, _lane = bits_stack.shape
    dev = bits_stack.device
    states = []
    for c in plan.circuits:
        states.append({
            f"st{s}": torch.full(
                (NWS, LANE), -1 if s == c.first_state else 0,
                dtype=torch.int32, device=dev,
            )
            for s in c.live_states
        })
    rows = []
    for i in range(L):
        logs_i = []
        for d, c in enumerate(plan.circuits):
            env = {
                name: bits_stack[i, plan.cls_off[d] + j]
                for j, name in enumerate(c.class_plane_names)
            }
            env.update(states[d])
            out = c.step_prog.run(env)
            logs_i += [out[f"log{j}"] for j in range(c.sb)]
            states[d] = {f"st{s}": out[f"nst{s}"] for s in c.live_states}
        rows.append(torch.stack(logs_i))  # [SB, NWS, LANE]
    return torch.stack(rows, 2).permute(1, 0, 2, 3).contiguous()


def scan(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """Stage 2, routed by device (see module docstring)."""
    if _on_cuda(bits_stack):
        from . import kernels

        return kernels.scan_cuda(plan, bits_stack)
    return scan_plain(plan, bits_stack)


# ---------------------------------------------------------------------------
# Stage 3: post (K3 on the card)
# ---------------------------------------------------------------------------


def post_plain(
    plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log planes [NWS, SB, L, LANE] and enable plane [NWS, L, LANE]
    -> byte-group words [NWS, 8G, L, LANE] and final-state boundary
    planes [NWS, n_defs, 8, LANE]: the JAX ``_make_post`` kernel in bytes
    mode with pre-dummied states.  Position-parallel: the mask FSMs run
    as log-scans here (the CUDA kernel runs them serially)."""
    NWS, _sb, L, _lane = logs.shape
    dev = logs.device
    zrow = torch.zeros((NWS, 1, LANE), dtype=torch.int32, device=dev)

    def shift_down(p, first):  # p[l] := p[l-1], row 0 := first
        return torch.cat([first, p[:, : L - 1]], 1)

    def shift_up(p):  # p[l] := p[l+1], last row := 0
        return torch.cat([p[:, 1:], zrow], 1)

    ids_sum = start_any = endf_any = None
    for d, c in enumerate(plan.circuits):
        nxt = [logs[:, plan.sb_off[d] + j] for j in range(c.sb)]
        prv = [
            shift_down(nxt[j], torch.full_like(zrow, -1 if plan.first_bit(d, j) else 0))
            for j in range(c.sb)
        ]
        env = {f"prev{j}": prv[j] for j in range(c.sb)}
        env.update({f"next{j}": nxt[j] for j in range(c.sb)})
        tag = c.tag_prog.run(env)
        idp = [tag[f"id{j}"] & en for j in range(plan.idb)]
        stp = tag["is_start"] & en
        efp = tag["is_end"] & en
        if ids_sum is None:
            ids_sum, start_any, endf_any = idp, stp, efp
        else:
            ids_sum = plane_add(ids_sum, idp, plan.idb + d.bit_length() + 1)
            start_any = start_any | stp
            endf_any = endf_any | efp

    # forward FSM (src/lib.rs:598-645)
    changed = _or_reduce(torch.stack([p ^ shift_down(p, zrow) for p in ids_sum]), 0)
    prev_endf = shift_down(endf_any, zrow)
    is_set = start_any & changed
    is_reset = ~start_any & prev_endf & changed
    fwd = _fsm_log_scan(~(is_set | is_reset), is_set, reverse=False)
    # backward FSM (src/lib.rs:663-714)
    changed_b = _or_reduce(torch.stack([p ^ shift_up(p) for p in ids_sum]), 0)
    next_start = shift_up(start_any)
    set_b = endf_any & changed_b
    reset_b = ~endf_any & next_start & changed_b
    bwd = _fsm_log_scan(~(set_b | reset_b), set_b, reverse=True)
    mask = fwd & bwd

    avail: Dict[str, List[torch.Tensor]] = {
        "flags": [mask, fwd, bwd, en, start_any, endf_any],
        "masked_idsum": [p & mask for p in ids_sum],
    }
    for d, c in enumerate(plan.circuits):
        planes = []
        for j in range(c.sb):
            p = logs[:, plan.sb_off[d] + j] & en
            if (plan.dummy_states[d] >> j) & 1:
                p = p | ~en
            planes.append(p)
        avail[f"states{d}"] = planes
    words = []
    for grp in plan.wgroups:
        planes = [p for name, _off, _nb in grp for p in avail[name]]
        planes += [torch.zeros_like(en)] * (8 - len(planes))
        words += transpose8_planes(planes)
    g4 = torch.stack(words, 1)

    # final-state boundary planes: per def the log bits at the last
    # enabled position (first state for empty strings)
    bnd = en & ~shift_up(en)
    empty = ~en[:, 0]  # [NWS, LANE]
    fb = torch.zeros((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
    for d, c in enumerate(plan.circuits):
        for j in range(c.sb):
            x = _or_reduce(bnd & logs[:, plan.sb_off[d] + j], 1)
            fb[:, d, j] = x | (empty if plan.first_bit(d, j) else 0)
    return g4, fb


def post(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor):
    """Stage 3, routed by device (see module docstring)."""
    if _on_cuda(logs, en):
        from . import kernels

        return kernels.post_cuda(plan, logs, en)
    return post_plain(plan, logs, en)


# ---------------------------------------------------------------------------
# Stage 4: decode + finish (plain torch on every device)
# ---------------------------------------------------------------------------


def decode_bytes(
    plan: BitplanePlan, g4: torch.Tensor, B: int, first_states: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Byte-group words -> [B, L] uint8 field columns, plus ``states``
    [B, n_defs, L+1]: each def's first state, then its states field,
    written in place.  Byte lane s of word (nws, lane) in group word b is
    string 4*(w + NW*b) + s, so the flat string order is dims
    (b, nws, lane, s).  The transpose to string-major runs on int32 words
    first (one pass over all groups), then on each field's byte lanes: on
    the H100 that is 1.9x faster than one byte-level transpose per field."""
    NWS = g4.shape[0]
    L = plan.L
    G = plan.n_groups
    words = g4.reshape(NWS, G, 8, L, LANE)
    words = words.permute(1, 2, 0, 4, 3).contiguous()  # [G, b, nws, lane, L]
    # int32 -> 4 uint8 lanes: torch widens the last dim instead of adding
    # an axis, so split it back out
    u8 = words.reshape(-1).view(torch.uint8).reshape(G, 8, NWS, LANE, L, 4)
    states = torch.empty((B, plan.n_defs, L + 1), dtype=torch.uint8, device=g4.device)
    states[:, :, 0] = first_states.to(torch.uint8)
    vals = {"states": states}
    for gi, grp in enumerate(plan.wgroups):
        arr = u8[gi]  # [b, nws, lane, L, s]
        for k, (name, off, nb) in enumerate(grp):
            v = arr >> off if off else arr
            if k + 1 < len(grp):  # the transpose zero-fills the bits above
                v = v & ((1 << nb) - 1)  # a group's last field
            v = v.permute(0, 1, 2, 4, 3)  # [b, nws, lane, s, L]: string-major
            if name.startswith("states"):
                d = int(name[len("states"):])
                states[:, d, 1:].view(8, NWS, LANE, 4, L).copy_(v)
            else:
                vals[name] = v.reshape(B, L)
    return vals


def final_from_fb(fb: torch.Tensor, B: int) -> torch.Tensor:
    """[NWS, n_defs, 8, LANE] boundary planes -> final states [B, n_defs]
    (bit beta = 8s+m of word w is string 4*(w + NW*m) + s)."""
    NW = B // 32
    n_defs = fb.shape[1]
    beta = torch.arange(32, dtype=torch.int32, device=fb.device)
    bits = (fb[..., None] >> beta) & 1  # [NWS, n_defs, 8, LANE, 32]
    shifts = torch.arange(8, dtype=torch.int32, device=fb.device)
    vals = (bits << shifts[None, None, :, None, None]).sum(2)  # [NWS, n_defs, LANE, 32]
    cols = [
        vals[:, d].reshape(NW, 4, 8).permute(2, 0, 1).reshape(B)
        for d in range(n_defs)
    ]
    return torch.stack(cols, 1)


def finish_witness(
    plan: BitplanePlan,
    tables: Dict[str, torch.Tensor],
    chars: torch.Tensor,
    vals: Dict[str, torch.Tensor],
    fb: torch.Tensor,
    B_orig: int,
) -> Dict[str, torch.Tensor]:
    """The compact witness dict of the JAX ``_finish_witness`` (bytes
    emission, pre-dummied states)."""
    B = chars.shape[0]
    flags = vals["flags"]
    mask = flags & 1
    final = final_from_fb(fb, B).long()
    d_idx = torch.arange(plan.n_defs, device=fb.device)[None, :]
    accepted = tables["accept_mask"][d_idx, final]
    has_dead = final == tables["dead_states"][None, :]
    out = dict(
        states=vals["states"],
        all_substr_ids=vals["masked_idsum"],
        masked_characters=mask * chars,
        flags=flags,
        mask=mask,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=accepted.all(1) & ~has_dead.any(1),
    )
    if B_orig != B:
        out = {k: v[:B_orig] for k, v in out.items()}
    return out


def witness(
    plan: BitplanePlan,
    tables: Dict[str, torch.Tensor],
    chars: torch.Tensor,
    lengths: torch.Tensor,
    plain: bool = False,
) -> Dict[str, torch.Tensor]:
    """The whole witness pipeline on ``chars`` [B, L] uint8 and ``lengths``
    [B] int32 (both on the device that runs it).  The batch is padded to
    a multiple of 32*LANE strings and the outputs sliced back.  ``plain``
    runs the plain version of every stage on any device (the reference
    the kernels are held against); otherwise stages route by device."""
    B_orig, L = chars.shape
    if L != plan.L:
        raise ValueError(f"chars are [B, {L}]; the model needs L={plan.L}")
    if lengths.shape != (B_orig,):
        raise ValueError(f"lengths {tuple(lengths.shape)}: expected ({B_orig},)")
    B = _round_up(max(B_orig, 1), TILE)
    if B != B_orig:
        pad = B - B_orig
        chars = torch.cat([chars, chars.new_zeros((pad, L))])
        lengths = torch.cat([lengths, lengths.new_zeros((pad,))])
    if plain:
        bits_stack, en = qpack_plain(plan, chars, len_table(lengths))
        logs = scan_plain(plan, bits_stack)
        g4, fb = post_plain(plan, logs, en)
    else:
        bits_stack, en = qpack(plan, chars, len_table(lengths))
        logs = scan(plan, bits_stack)
        g4, fb = post(plan, logs, en)
    vals = decode_bytes(plan, g4, B, tables["first_states"])
    return finish_witness(plan, tables, chars, vals, fb, B_orig)


# ---------------------------------------------------------------------------
# The matcher
# ---------------------------------------------------------------------------


class BitplaneMatcher(nn.Module):
    """Bit-sliced witness matcher (port of the JAX ``BitplaneMatcher``).

    Only ``columns="witness"`` with the default knobs is ported: calling
    returns the dict of ``halo2_regex_tpu``'s ``_finish_witness`` (keys
    states, all_substr_ids, masked_characters, flags, mask, accepted,
    has_dead, match_ok).  The model's tables are registered buffers and
    follow ``.to(device)``; ``device="cuda"`` runs the CUDA kernels and
    raises where CUDA is absent.

    Args mirror the JAX constructor, less ``lc`` and ``max_step_ops``
    (TPU tile and VMEM limits), with ``columns`` defaulting to the only
    value the port runs.  Settings it does not run yet raise
    ``NotImplementedError`` naming their ROADMAP item.
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        post: str = "kernel",
        columns: str = "witness",
        class_stage=None,
        unroll: Optional[int] = None,
        fuse_pack: Optional[bool] = None,
        en_pack: Optional[bool] = None,
        qpack: Optional[bool] = None,
        emit: Optional[str] = None,
        input_layout: str = "bl",
        device=None,
    ):
        super().__init__()
        if columns not in ("full", "witness", "match"):
            raise ValueError(f"columns={columns!r}: expected full/witness/match")
        if columns != "witness":
            item = "A5 (full RegexResult columns)" if columns == "full" else (
                "A4 (match-only serving)"
            )
            raise NotImplementedError(
                f"columns={columns!r} waits for ROADMAP {item}; the port "
                "runs columns='witness'"
            )
        if input_layout not in ("bl", "tiled"):
            raise ValueError(f"input_layout={input_layout!r}: expected bl/tiled")
        if input_layout == "tiled":
            raise NotImplementedError(
                "input_layout='tiled' waits for ROADMAP A8 (tiled input)"
            )
        if post == "xla":
            raise NotImplementedError(
                "post='xla' waits for ROADMAP A11; the port runs the fused "
                "post kernel (post='kernel')"
            )
        if post != "kernel":
            raise ValueError(f"post={post!r}: expected kernel")
        check_main_path(
            unroll=unroll, fuse_pack=fuse_pack, class_stage=class_stage,
            en_pack=en_pack, qpack=qpack, emit=emit,
        )
        self.model = model
        self.plan = make_plan(model)
        self.register_buffer(
            "accept_mask", torch.from_numpy(np.asarray(model.accept_mask, bool))
        )
        for name in ("first_states", "dead_states"):
            self.register_buffer(
                name, torch.from_numpy(np.asarray(getattr(model, name), np.int64))
            )
        device = torch.device(device if device is not None else "cpu")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available"
            )
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"device={str(device)!r}: expected cpu or cuda")
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.accept_mask.device

    def tables(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    @torch.no_grad()
    def forward(self, chars, lengths) -> Dict[str, torch.Tensor]:
        chars = torch.as_tensor(chars, dtype=torch.uint8, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return witness(self.plan, self.tables(), chars.contiguous(),
                       lengths.contiguous())

    def match_one(self, characters: bytes) -> Dict[str, np.ndarray]:
        buf = np.zeros((1, self.plan.L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        out = self(buf, np.array([len(characters)], np.int32))
        return {k: v[0].cpu().numpy() for k, v in out.items()}
