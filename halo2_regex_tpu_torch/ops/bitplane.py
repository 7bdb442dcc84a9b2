"""Bit-sliced (bitplane) matcher, PyTorch port.

The port of ``halo2_regex_tpu.ops.bitplane.BitplaneMatcher``, for its
three column sets and every knob value it accepts.  Thirty-two strings
share each int32 word and the DFA runs as synthesized boolean circuits
(:mod:`..compiler.bitslice`):

  1. **pack**: [B, L] bytes -> 8 byte-bit planes -> each def's byte->class
     circuit -> class planes (binary or one-hot; with the class stage off,
     the 8 byte-bit planes themselves) [L_pad, KP, NWS, LANE], plus the
     enable plane (pos < len) [NWS, L_pad, LANE] (with ``en_pack`` off,
     ``enable_plane`` builds it with torch ops).  ``qpack`` reads the
     [B, L] bytes directly (when L_pad == L); ``pack`` reads the raw quad
     rows of ``raw_quads`` (any L, or ``qpack=False``); ``tpack`` reads the
     host-pretiled quad words of ``tile_corpus`` (``input_layout="tiled"``).
     With ``fuse_pack`` there is no pack: ``scan_fpack`` reads the raw
     quad rows.
  2. **scan**: the only sequential stage.  One-hot live-state planes are
     carried across the bytes; each byte runs every def's step circuit and
     writes log2-encoded state planes [NWS, SB, L_pad, LANE].
     ``scan_def`` runs one def's alone (``BitplaneMatcher.scan_planes``).
  3. the tail, by ``columns``:
     - ``"witness"``, by the resolved ``emit``: **post** (tag circuit on
       (prev, next) state planes, id sum across defs, forward/backward mask
       FSMs, dummy splice, 8x8 bit transpose into byte-group words [NWS,
       8G, L_pad, LANE], plus the final-state boundary planes ``fb`` [NWS,
       n_defs, 8, LANE]; with tiled input it also emits the masked
       characters from the quad words), then ``decode_bytes`` ("bytes") or
       the **decode** kernel ("kdecode"); **post_direct** ("direct": one
       string-major array per field, whose [B, L] columns are views); or
       **post_planes** / ``post_xla`` ("planes": the named planes, then
       ``unpack_groups``); then ``finish_witness``;
     - ``"full"``: **post_planes** (the same tags, id sum and FSMs, written
       as named bit planes [NWS, P_total, L_pad, LANE]) or, with
       ``post="xla"``, ``post_xla`` (torch ops), then ``unpack_groups`` and
       ``finish_full`` -> a ``RegexResult``;
     - ``"match"``: **fb_only** (the boundary planes alone), then
       ``finish_match`` -> final states and verdicts.

The packed layout is the JAX package's exactly, so every intermediate can
be compared array for array: word ``w`` of a plane holds, at bit
``beta``, string ``g(w, beta) = 4*(w + NW*(beta % 8)) + beta // 8``
(NW = B/32), and planes are NWS-major with LANE = 128 words per row.
Rows at positions L..L_pad-1 have enable 0, so tags, FSMs and boundaries
ignore them; the decodes slice them off.

Each kernel stage has a plain PyTorch version here (``qpack_plain``,
``pack_plain``, ``tpack_plain``, ``scan_plain``, ``scan_fpack_plain``,
``scan_def_plain``, ``post_plain``, ``post_planes_plain``,
``post_direct_plain``, ``decode_plain``, ``fb_only_plain``) and a
hand-written CUDA kernel in ``csrc/`` (bound by :mod:`.kernels`).  The
stage functions without ``_plain`` route by device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (or raises).  There
is no fallback between the two.  The post kernel's chunked mask FSMs
have torch twins (``post_chunks_plain``, ``post_direct_chunks_plain``),
which the tests hold to the plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..compiler.bitslice import DefCircuits, synthesize_def
from ..models.compiled import CompiledRegexModel
from ..witness.result import RegexResult
from .knobs import BitplaneKnobs, scan_unroll

LANE = 128
TILE = 32 * LANE  # strings per NWS row: the batch is padded to a multiple
LC = 128  # the JAX matcher's default L chunk: L_pad rounds L up to it
_QUAD_MASK = 0x01010101
COLUMNS = ("full", "witness", "match")


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


def _byte_groups(fields) -> List[Tuple[Tuple[str, int, int], ...]]:
    """Greedy packing of (name, bit count) fields into <= 8-bit groups of
    (name, first bit, bit count), as the JAX matcher packs them."""
    groups: List[Tuple[Tuple[str, int, int], ...]] = []
    cur: List[Tuple[str, int, int]] = []
    bits = 0
    for name, nb in fields:
        if bits + nb > 8 and cur:
            groups.append(tuple(cur))
            cur, bits = [], 0
        cur.append((name, bits, nb))
        bits += nb
    if cur:
        groups.append(tuple(cur))
    return groups


# ---------------------------------------------------------------------------
# The plan: everything static about one matcher
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)  # hashed by identity: kernels.build keys on it
class BitplanePlan:
    """Model-derived layout shared by the kernels and their plain versions.

    ``L_pad``: L for L <= 128, else L rounded up to a multiple of 128 (the
    JAX matcher's default ``lc``); every plane has L_pad rows.
    ``class_stage``: False (the scan's step circuits fold the class BDD in
    and read the 8 byte-bit planes: KP = 8), "binary" or "onehot" (the pack
    runs each def's class circuit and writes its class planes).
    ``fuse_pack``: no pack kernel; the scan reads raw quad rows and
    extracts the byte-bit planes itself (``scan_fpack``).  ``en_pack``: the
    pack kernel writes the enable plane (else torch ops build it).
    ``qpack``: pack from the [B, L] bytes (K1) rather than from raw quad
    rows (B5); only when L_pad == L.  ``tiled``: the input is the pretiled
    quad-word buffer of ``tile_corpus`` (the pack is B6, and the witness
    emission adds the 8-bit field ``masked_characters_pre``).
    ``cls_off[d]`` / ``sb_off[d]``: def d's first class plane / log plane
    in the concatenated stacks.  ``post``: "pallas" (the fused post
    kernel) or "xla" (torch ops).  ``emit`` (witness only, else "planes"):
    the witness tail, resolved as the JAX matcher resolves it -- "bytes"
    (byte groups ``wgroups``, each a tuple of (field, first bit, bit count)
    with at most 8 bits; ``flags`` = mask, fwd, bwd, en, start_any,
    endf_any), "kdecode" (the same groups, then the decode kernel),
    "direct" (one string-major array per field of ``dfields``) or
    "planes" (the named planes of ``post_off``).  ``post_off`` (full, and
    witness planes): name -> (first plane, plane count) of the planes-mode
    post output, ``p_total`` planes in all.  ``unroll``: the CUDA scans'
    position-loop unroll.  ``compact``: full mode's uint8 columns (else
    int32)."""

    circuits: Tuple[DefCircuits, ...]
    columns: str
    L: int
    L_pad: int
    qpack: bool
    tiled: bool
    compact: bool
    idb: int
    nsum: int
    cls_off: Tuple[int, ...]
    kp: int
    sb_off: Tuple[int, ...]
    sb_sum: int
    wgroups: Tuple[Tuple[Tuple[str, int, int], ...], ...]
    post_off: Dict[str, Tuple[int, int]]
    p_total: int
    first_states: Tuple[int, ...]
    dummy_states: Tuple[int, ...]
    class_stage: object = "binary"
    fuse_pack: bool = False
    en_pack: bool = True
    post: str = "pallas"
    emit: str = "planes"
    dfields: Tuple[Tuple[str, int], ...] = ()
    unroll: int = 4

    @property
    def n_defs(self) -> int:
        return len(self.circuits)

    @property
    def n_groups(self) -> int:
        return len(self.wgroups)

    @property
    def fields_flat(self) -> Tuple[Tuple[str, int, int, int], ...]:
        """(field, group, first bit, bit count) of every byte-group field."""
        return tuple((name, gi, off, nb) for gi, grp in enumerate(self.wgroups)
                     for name, off, nb in grp)

    @property
    def l4(self) -> int:
        """Columns of the l4-packed string-major arrays (4 positions per
        int32) of the direct and kdecode emissions."""
        return self.L_pad // 4

    def first_bit(self, d: int, j: int) -> bool:
        return bool((self.first_states[d] >> j) & 1)


def make_plan(
    model: CompiledRegexModel,
    columns: str = "full",
    qpack: Optional[bool] = None,
    compact: bool = True,
    tiled: bool = False,
    knobs: Optional[BitplaneKnobs] = None,
    post: str = "pallas",
    unroll: int = 4,
) -> BitplanePlan:
    """Synthesize every def's circuits under ``knobs`` (the main path's
    when None; ``qpack``, when given, overrides theirs) and lay out the
    plane stacks, and the post output of ``columns``, as the JAX matcher
    does (halo2_regex_tpu/ops/bitplane.py:556-830)."""
    if columns not in COLUMNS:
        raise ValueError(f"columns={columns!r}: expected full/witness/match")
    if tiled and columns == "full":  # halo2_regex_tpu/ops/bitplane.py:545-550
        raise ValueError(
            "input_layout='tiled' supports columns='witness'/'match' "
            "only: the full RegexResult set emits all_characters, "
            "which needs the string-major [B, L] chars"
        )
    if post not in ("pallas", "xla"):
        raise ValueError(f"post={post!r}: expected pallas/xla")
    knobs = knobs or BitplaneKnobs()
    class_stage = knobs.class_stage
    n_defs = model.n_defs
    L = model.max_chars_size
    L_pad = _round_up(L, min(LC, L))
    idb = max(1, int(model.total_substrs).bit_length())
    circuits = []
    for d in range(n_defs):
        c = synthesize_def(
            model.transition[d],
            int(model.first_states[d]),
            int(model.dead_states[d]),
            _substr_pairs(model, d),
            idb=idb,
            fold_class=not class_stage,
            class_encoding=class_stage if class_stage else "onehot",
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

    # the witness emission (halo2_regex_tpu/ops/bitplane.py:722-769)
    emit, groups, dfields = "planes", [], ()
    if columns == "witness" and post == "pallas":
        want = knobs.emit if knobs.emit is not None else "bytes"
        fields = [("flags", 6), ("masked_idsum", nsum)]
        fields += [(f"states{d}", c.sb) for d, c in enumerate(circuits)]
        if tiled:
            # the post kernel assembles mask & chars from the quad words
            fields.append(("masked_characters_pre", 8))
        # a field wider than 8 bits takes the planes emission
        if want != "planes" and all(nb <= 8 for _, nb in fields):
            if want == "direct" and L_pad % 4 == 0:
                emit, dfields = "direct", tuple(fields)
            else:
                emit = "kdecode" if want == "kdecode" and L_pad % 4 == 0 else "bytes"
                groups = _byte_groups(fields)
    if tiled and columns == "witness" and emit != "bytes":
        raise ValueError(f"input_layout='tiled' witness emission requires "
                         f"emit='bytes' (resolved emit={emit!r})")
    if emit != "planes":
        # The post stage splices each def's dummy state into its log planes
        # where enable is off.  dummy = largest + 1 < dead, and dead is a
        # live state, so the dummy always fits the def's sb planes.
        for d, c in enumerate(circuits):
            if int(model.dummy_states[d]).bit_length() > c.sb:
                raise ValueError(f"def {d}: dummy state does not fit {c.sb} planes")

    # the planes-mode post output (halo2_regex_tpu/ops/bitplane.py:671-704)
    plan_fields = []
    if columns == "witness" and emit == "planes":
        plan_fields = [("masked_idsum", nsum), ("fwd", 1), ("bwd", 1), ("mask", 1),
                       ("start_any", 1), ("endf_any", 1)]
    elif columns == "full":
        for d in range(n_defs):
            plan_fields += [(f"ids{d}", idb), (f"start{d}", 1), (f"endf{d}", 1)]
        plan_fields += [("idsum", nsum), ("masked_idsum", nsum), ("fwd", 1),
                        ("bwd", 1), ("mask", 1)]
    post_off: Dict[str, Tuple[int, int]] = {}
    off = 0
    for name, nb in plan_fields:
        post_off[name] = (off, nb)
        off += nb
    # the tiled pack always computes the enable plane, and the tiled
    # pipeline runs no in-scan pack (halo2_regex_tpu/ops/bitplane.py:1831)
    fuse_pack = knobs.fuse_pack and not tiled
    qpack = knobs.qpack if qpack is None else qpack
    return BitplanePlan(
        circuits=tuple(circuits),
        columns=columns,
        L=L,
        L_pad=L_pad,
        qpack=bool(qpack) and L_pad == L and not tiled and not fuse_pack,
        tiled=tiled,
        compact=compact,
        idb=idb,
        nsum=nsum,
        cls_off=tuple(cls_off),
        kp=off_c if class_stage else 8,
        sb_off=tuple(sb_off),
        sb_sum=off_sb,
        wgroups=tuple(groups),
        post_off=post_off,
        p_total=off,
        first_states=tuple(int(s) for s in model.first_states),
        dummy_states=tuple(int(s) for s in model.dummy_states),
        class_stage=class_stage,
        fuse_pack=fuse_pack,
        en_pack=knobs.en_pack or tiled,
        post=post,
        emit=emit,
        dfields=dfields,
        unroll=unroll,
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


def _quad_rows(chars: torch.Tensor, L_pad: int) -> torch.Tensor:
    """[B, L] uint8 (B a multiple of 32) -> [L_pad, 8, B//32] int32 quad
    rows: row (l, m, w) holds bytes s = 0..3 of strings 4*(w + NW*m) + s at
    position l (zeros past L)."""
    B, L = chars.shape
    if B % 32 or L > L_pad:
        raise ValueError(f"chars are [{B}, {L}]: expected B a multiple of 32 and L <= {L_pad}")
    x = chars.t()
    if L_pad != L:
        x = torch.cat([x, x.new_zeros((L_pad - L, B))])
    # flat first: a size-1 dim may keep any stride, which view(int32) refuses
    return x.contiguous().reshape(-1).view(torch.int32).reshape(L_pad, 8, B // 32)


def raw_quads(chars: torch.Tensor, L_pad: int) -> torch.Tensor:
    """[B, L] uint8 -> raw quad rows [L_pad, 8, NWS, LANE] int32: the
    transpose, zero pad and bitcast of the JAX ``raw_quads``
    (halo2_regex_tpu/ops/bitplane.py:108).  Row (l, m, w) holds bytes
    s = 0..3 of strings 4*(w + NW*m) + s at position l."""
    B = chars.shape[0]
    return _quad_rows(chars, L_pad).reshape(L_pad, 8, B // TILE, LANE)


def pack_bytes(chars: torch.Tensor, L_pad: int) -> List[torch.Tensor]:
    """[B, L] uint8 (B a multiple of 32) -> the 8 byte-bit planes [L_pad,
    B//32] int32, zeros past L: bit 8s + m of plane j at word w is bit j
    of string 4*(w + NW*m) + s (the JAX ``pack_bytes``,
    halo2_regex_tpu/ops/bitplane.py:168).  Torch ops on the input's device."""
    R = _quad_rows(chars, L_pad)
    return _byte_planes([R[:, m] for m in range(8)])


def pack_bool(col: torch.Tensor, L_pad: int) -> torch.Tensor:
    """[B, L] bool or 0/1 (B a multiple of 32) -> one plane [L_pad, B//32]
    int32 in ``pack_bytes``' mapping (the JAX ``pack_bool``,
    halo2_regex_tpu/ops/bitplane.py:192)."""
    R = _quad_rows(col.to(torch.uint8), L_pad) & _QUAD_MASK
    acc = R[:, 0]
    for m in range(1, 8):
        acc = acc | (R[:, m] << m)
    return acc


def tile_corpus(chars: np.ndarray, L_pad: int) -> np.ndarray:
    """Host packer of the tiled input contract (``input_layout="tiled"``):
    [B, L] uint8 chars -> [NWS, 8, L_pad, LANE] int32 quad words, the
    ``raw_quads`` tiling with the word-group axis leading, so every device
    read is contiguous: T[nws, m, l, lane] packs bytes s = 0..3 of strings
    4*((nws*LANE + lane) + NW*m) + s at position l.  B is padded up to a
    multiple of 32*LANE (trailing strings read as empty: pass the unpadded
    lengths and the matcher slices its outputs back) and L up to L_pad
    with zero bytes.  The multithreaded C++ packer (``native``) where g++
    exists, else numpy; the two give the same array."""
    from .. import native

    B, L = chars.shape
    if L > L_pad:
        raise ValueError(f"chars are [B, {L}]: longer than L_pad={L_pad}")
    if native.available():
        return native.tile_corpus(chars, L_pad)
    Bp = _round_up(B, TILE)
    x = np.zeros((L_pad, Bp), np.uint8)
    x[:L, :B] = np.asarray(chars, np.uint8).T
    words = x.reshape(L_pad, Bp // 4, 4).view(np.int32)[..., 0]
    return np.ascontiguousarray(words.reshape(L_pad, 8, Bp // TILE, LANE).transpose(2, 1, 0, 3))


def tile_corpus_device(chars: torch.Tensor, L_pad: int) -> torch.Tensor:
    """``tile_corpus`` of [B, L] uint8 chars on their device (the JAX
    ``tile_corpus_jax``, halo2_regex_tpu/ops/bitplane.py:151): ``raw_quads``
    of the batch padded to a multiple of 32*LANE strings, with the
    word-group axis moved first -> [NWS, 8, L_pad, LANE] int32, equal to
    the host packer's array.  For rows that already lie on the card (the
    device-expand ``ScanJob``); it pays the transpose that host tiling
    exists to avoid."""
    B, L = chars.shape
    if L > L_pad:
        raise ValueError(f"chars are [B, {L}]: longer than L_pad={L_pad}")
    if B % TILE:
        chars = torch.cat([chars, chars.new_zeros((TILE - B % TILE, L))])
    return raw_quads(chars, L_pad).permute(2, 1, 0, 3).contiguous()


def transpose8(x: torch.Tensor) -> torch.Tensor:
    """SWAR 8x8 bit-block transpose of eight stacked int32 planes
    [8, ...]: output word ``O_b`` holds, in byte lane ``s`` bit ``j``, the
    bit ``P_j[8s+b]``, i.e. the value bytes of the four strings at
    ``beta % 8 == b``.  Each of the three stages swaps the bit blocks of
    every plane pair (i, i + d) at once, on views of the stack.  The masks
    make arithmetic right shifts safe (sign bits are masked off)."""
    shape = x.shape
    for d, mask in ((4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        y = x.reshape(8 // (2 * d), 2, d, -1)  # [:, 0] planes i, [:, 1] planes i + d
        a, b = y[:, 0], y[:, 1]
        t = ((a >> d) ^ b) & mask
        x = torch.stack([a ^ (t << d), b ^ t], 1)
    return x.reshape(shape)


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


def _shift_down(p: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """[NWS, L, LANE]: p[l] := p[l-1], row 0 := first [NWS, 1, LANE]."""
    return torch.cat([first, p[:, :-1]], 1)


def _shift_up(p: torch.Tensor) -> torch.Tensor:
    """[NWS, L, LANE]: p[l] := p[l+1], last row := 0."""
    return torch.cat([p[:, 1:], torch.zeros_like(p[:, :1])], 1)


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


def resolve_device(device) -> torch.device:
    """A matcher's device: the card unless the caller asks for the CPU.
    ``"cuda"`` (the default) raises where CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available "
            "(pass device='cpu' to run the plain versions on the CPU)"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device={str(device)!r}: expected cpu or cuda")
    return device


def _kernels():
    from . import kernels

    return kernels


# ---------------------------------------------------------------------------
# Stage 1: pack (K1 qpack / B5 pack_raw on the card)
# ---------------------------------------------------------------------------


def _byte_planes(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """The quad words of one position, ``rows[m]`` for m = 0..7 (bytes
    s = 0..3 of strings 4*(w + NW*m) + s), -> the 8 byte-bit planes: bit
    beta = 8s + m of plane j is bit j of that string's byte."""
    planes = []
    for j in range(8):
        acc = None
        for m in range(8):
            v = ((rows[m] >> j) & _QUAD_MASK) << m
            acc = v if acc is None else acc | v
        planes.append(acc)
    return planes


def enable_plane(len_wb: torch.Tensor, L_pad: int) -> torch.Tensor:
    """The [NWS, LANE, 32] length table -> the enable plane [NWS, L_pad,
    LANE] int32: bit beta of word w at position l is l < the length of
    string g(w, beta).  Torch ops where the pack kernel does not compute
    it (en_pack off, fuse_pack), as the JAX matcher's XLA pass does
    (halo2_regex_tpu/ops/bitplane.py:1799-1805)."""
    NWS = len_wb.shape[0]
    dev = len_wb.device
    pos = torch.arange(L_pad, dtype=torch.int32, device=dev)
    lt = (pos[None, :, None, None] < len_wb[:, None]).to(torch.uint8)  # [NWS, L_pad, LANE, 32]
    # bits 8k..8k+7 of the word are its byte k (little endian): all 32
    # bits in one pass
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    by = (lt.view(NWS, L_pad, LANE, 4, 8) << shifts).sum(-1, dtype=torch.uint8)
    return by.view(torch.int32).reshape(NWS, L_pad, LANE)


def pack_plain(
    plan: BitplanePlan, quads: torch.Tensor, len_wb: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Raw quad rows [L_pad, 8, NWS, LANE] and the [NWS, LANE, 32] length
    table -> the scan's input planes [L_pad, KP, NWS, LANE] (each def's
    class planes, or the 8 byte-bit planes when the class stage is off)
    and the enable plane [NWS, L_pad, LANE] (int32; None when en_pack is
    off).  Same function as the JAX ``_make_pack`` kernel."""
    planes = _byte_planes([quads[:, m] for m in range(8)])  # each [L_pad, NWS, LANE]
    bits_stack = _class_planes(plan, planes)
    return bits_stack, enable_plane(len_wb, quads.shape[0]) if plan.en_pack else None


def qpack_plain(
    plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, L] uint8 chars (L == L_pad) and the length table -> as
    ``pack_plain``: the JAX ``_make_qpack`` kernel computes the pack
    kernel's function from the bytes directly."""
    return pack_plain(plan, raw_quads(chars, chars.shape[1]), len_wb)


def _class_planes(plan: BitplanePlan, planes: List[torch.Tensor]) -> torch.Tensor:
    """The 8 byte-bit planes -> the scan's input planes stacked on dim 1:
    each def's class planes, or the byte-bit planes with the class stage
    off."""
    if plan.class_stage:
        env = {f"byte_bit{j}": planes[j] for j in range(8)}
        cls = []
        for c in plan.circuits:
            out = c.class_prog.run(env)
            cls += [out[name] for name in c.class_plane_names]
    else:
        cls = planes
    return torch.stack(cls, 1).contiguous()


_U32 = 0xFFFFFFFF


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit words held in int64 -> the same bits as int32."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on int64-held words: byte i of the
    result is byte ``sel >> 4i & 7`` of the eight bytes x[0..3], y[0..3]."""
    out = torch.zeros_like(x)
    for i in range(4):
        k = sel >> 4 * i & 7
        src = x if k < 4 else y
        out = out | (src >> 8 * (k & 3) & 0xFF) << 8 * i
    return out


def bytes4x4(v: List[torch.Tensor]) -> List[torch.Tensor]:
    """``h2r_bytes4x4`` of ``csrc/bitplane_common.cuh``, its __byte_perm
    steps on int64-held words: o[s] byte j = v[j] byte s."""
    t0, t1 = byte_perm(v[0], v[1], 0x5140), byte_perm(v[2], v[3], 0x5140)
    t2, t3 = byte_perm(v[0], v[1], 0x7362), byte_perm(v[2], v[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]


def byte_planes_swar(rows: List[torch.Tensor]) -> List[torch.Tensor]:
    """``_byte_planes`` as the pack kernels compute it (``h2r_byte_planes``):
    plane j byte s bit m is quad word m byte s bit j, the 8 x 8 bit
    transpose within each byte lane, which ``transpose8`` is."""
    return list(transpose8(torch.stack(rows)).unbind(0))


def enable_runs(len_wb: torch.Tensor, L_pad: int) -> torch.Tensor:
    """``enable_plane`` as K1 (``csrc/bitplane_pack.cu``) and the quad-word
    pack (``csrc/bitplane_pack_words.cuh``) compute it: for each 32
    positions from l0, lane beta of a warp holds string beta's run mask
    (1 << clamp(len - l0, 0, 32)) - 1 (bit p: position l0 + p is below its
    length), and five shuffle rounds transpose the warp's 32 x 32 bits, so
    lane p holds the enable word of position l0 + p (round j swaps bit j
    of the lane and bit index: a lane whose bit j is clear takes its
    partner's bits c - j into its bits c with bit j set, the partner the
    reverse)."""
    NWS = len_wb.shape[0]
    dev = len_wb.device
    n_t = -(-L_pad // 32)
    lens = len_wb.reshape(-1, 1, 32).long()  # [NW, 1, lane]
    l0 = 32 * torch.arange(n_t, device=dev)[None, :, None]
    n = (lens - l0).clamp(0, 32)
    x = torch.where(n == 32, _U32, (1 << n.clamp(max=31)) - 1)  # [NW, tile, lane]
    lane = torch.arange(32, device=dev)
    for j, hi in ((16, 0xFFFF0000), (8, 0xFF00FF00), (4, 0xF0F0F0F0), (2, 0xCCCCCCCC),
                  (1, 0xAAAAAAAA)):
        y = x[..., lane ^ j]  # __shfl_xor_sync
        lo = _U32 ^ hi
        x = torch.where((lane & j) != 0, (x & hi) | (y >> j & lo), (x & lo) | (y << j & hi))
    en = _to_int32(x).reshape(NWS, LANE, n_t * 32)[..., :L_pad]
    return en.transpose(1, 2).contiguous()


def qpack_tiles_plain(
    plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``qpack_plain``'s function as K1 (``csrc/bitplane_pack.cu``) computes
    it, for tests (no pipeline calls it): the four strings 4 * (w + NW * m)
    + s (s = 0..3) of each quad, four positions at a time, go through the
    kernel's 4 x 4 byte transpose (``bytes4x4``) into the quad words of
    those positions; then ``byte_planes_swar``, the class circuits, and
    ``enable_runs`` for the enable plane (None with en_pack off)."""
    B, L = chars.shape
    NW = B // 32
    Lq = _round_up(L, 4)
    x = torch.zeros((B, Lq), dtype=torch.uint8, device=chars.device)
    x[:, :L] = chars
    # v[s]: string 4 * (w + NW * m) + s's bytes at positions 4c .. 4c + 3
    words = x.reshape(8, NW, 4, Lq // 4, 4).long()
    words = sum(words[..., t] << 8 * t for t in range(4))  # [m, w, s, c]
    o = bytes4x4([words[:, :, s] for s in range(4)])  # o[j]: position 4c + j, [m, w, c]
    quads = torch.stack(o, -1).reshape(8, NW, Lq)[..., :L]
    rows = [_to_int32(quads[m].t()).reshape(L, NW // LANE, LANE) for m in range(8)]
    bits_stack = _class_planes(plan, byte_planes_swar(rows))
    return bits_stack, enable_runs(len_wb, L) if plan.en_pack else None


PW_TW = PW_TP = 32  # kPwTW, kPwTP of csrc/bitplane_pack_words.cuh: a tile's words, positions


def pack_words_tiles_plain(
    plan: BitplanePlan, quads: torch.Tensor, len_wb: torch.Tensor, tiled: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``pack_plain``'s function (``tpack_plain``'s with ``tiled``: the
    quads are then [NWS, 8, L_pad, LANE]) as the quad-word pack kernel
    (``csrc/bitplane_pack_words.cuh``) computes it, for tests (no pipeline
    calls it): each tile of ``PW_TW`` words x ``PW_TP`` positions is
    staged from the flat quads by the kernel's strides (s_nws, s_m, s_l),
    as 8 x 32 pieces of 32 words; lane = word, warp wp at positions wp + 8
    u computes its word from the eight staged words (``byte_planes_swar``,
    the class circuits); the enable plane is ``enable_runs``'s (the run
    masks over each tile's 32 positions and the warp bit transpose).
    Word-positions the mapping missed stay zero."""
    dev = quads.device
    if tiled:
        NWS, _, L, _ = quads.shape
        s_nws, s_m, s_l = 8 * L * LANE, L * LANE, LANE
    else:
        L, _, NWS, _ = quads.shape
        s_nws, s_m, s_l = LANE, NWS * LANE, 8 * NWS * LANE
    NW = NWS * LANE
    n_pt = -(-L // PW_TP)
    ar = torch.arange
    # tile t = (word group, position tile); warp wp, step u: position wp + 8 u
    t = ar(NW // PW_TW * n_pt, device=dev)[:, None, None, None]
    wp, u = ar(8, device=dev)[:, None, None], ar(PW_TP // 8, device=dev)[:, None]
    w0, l = t // n_pt * PW_TW, t % n_pt * PW_TP + wp + 8 * u  # [t, wp, u, 1]
    w = w0 + ar(PW_TW, device=dev)  # [t, 1, 1, lane]
    l, w = (x.reshape(-1) for x in torch.broadcast_tensors(l, w))
    keep = l < L
    l, w = l[keep], w[keep]
    idx = ((w // LANE) * s_nws + w % LANE + l * s_l)[None, :] + ar(8, device=dev)[:, None] * s_m
    q = quads.reshape(-1)[idx]  # [m, word-position]
    cls = _class_planes(plan, byte_planes_swar(list(q.unbind(0))))  # [word-position, KP]
    out = torch.zeros((L, cls.shape[1], NW), dtype=torch.int32, device=dev)
    out[l, :, w] = cls
    out = out.reshape(L, cls.shape[1], NWS, LANE)
    return out, enable_runs(len_wb, L) if plan.en_pack else None


def qpack(plan: BitplanePlan, chars: torch.Tensor, len_wb: torch.Tensor):
    """Stage 1 from [B, L] bytes, routed by device (module docstring)."""
    if _on_cuda(chars, len_wb):
        return _kernels().qpack_cuda(plan, chars, len_wb)
    return qpack_plain(plan, chars, len_wb)


def pack(plan: BitplanePlan, quads: torch.Tensor, len_wb: torch.Tensor):
    """Stage 1 from raw quad rows, routed by device (module docstring)."""
    if _on_cuda(quads, len_wb):
        return _kernels().pack_raw_cuda(plan, quads, len_wb)
    return pack_plain(plan, quads, len_wb)


def tpack_plain(
    plan: BitplanePlan, tiled: torch.Tensor, len_wb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pretiled quad words [NWS, 8, L_pad, LANE] (``tile_corpus``) and the
    length table -> as ``pack_plain``: the JAX ``_make_tpack`` kernel is the
    pack kernel's function on the tiled words viewed back to quad rows."""
    return pack_plain(plan, tiled.permute(2, 1, 0, 3), len_wb)


def tpack(plan: BitplanePlan, tiled: torch.Tensor, len_wb: torch.Tensor):
    """Stage 1 from pretiled quad words, routed by device (module
    docstring)."""
    if _on_cuda(tiled, len_wb):
        return _kernels().tpack_cuda(plan, tiled, len_wb)
    return tpack_plain(plan, tiled, len_wb)


# ---------------------------------------------------------------------------
# Stage 2: scan (K2 on the card)
# ---------------------------------------------------------------------------


def _scan_defs(plan: BitplanePlan, bits_stack: torch.Tensor, defs) -> torch.Tensor:
    """The serial recurrence of the defs ``defs`` over the scan's input
    planes [L_pad, KP, NWS, LANE] -> their log state planes, concatenated
    [NWS, sum of their sb, L_pad, LANE]; one byte position per Python step.
    A def whose circuits fold the class BDD in reads the 8 byte-bit
    planes, else its class planes at ``cls_off[d]``."""
    L, _kp, NWS, _lane = bits_stack.shape
    dev = bits_stack.device
    states = {}
    for d in defs:
        c = plan.circuits[d]
        states[d] = {
            f"st{s}": torch.full(
                (NWS, LANE), -1 if s == c.first_state else 0,
                dtype=torch.int32, device=dev,
            )
            for s in c.live_states
        }
    rows = []
    for i in range(L):
        logs_i = []
        for d in defs:
            c = plan.circuits[d]
            if c.fold_class:
                env = {f"byte_bit{j}": bits_stack[i, j] for j in range(8)}
            else:
                env = {name: bits_stack[i, plan.cls_off[d] + j]
                       for j, name in enumerate(c.class_plane_names)}
            env.update(states[d])
            out = c.step_prog.run(env)
            logs_i += [out[f"log{j}"] for j in range(c.sb)]
            states[d] = {f"st{s}": out[f"nst{s}"] for s in c.live_states}
        rows.append(torch.stack(logs_i))  # [SB, NWS, LANE]
    return torch.stack(rows, 2).permute(1, 0, 2, 3).contiguous()


def scan_plain(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """The scan's input planes [L_pad, KP, NWS, LANE] -> log state planes
    [NWS, SB, L_pad, LANE] of every def: the JAX ``_make_scan_fused``
    kernel."""
    return _scan_defs(plan, bits_stack, range(plan.n_defs))


def scan(plan: BitplanePlan, bits_stack: torch.Tensor) -> torch.Tensor:
    """Stage 2, routed by device (see module docstring)."""
    if _on_cuda(bits_stack):
        return _kernels().scan_cuda(plan, bits_stack)
    return scan_plain(plan, bits_stack)


def scan_fpack_plain(plan: BitplanePlan, quads: torch.Tensor) -> torch.Tensor:
    """Raw quad rows [L_pad, 8, NWS, LANE] -> log state planes [NWS, SB,
    L_pad, LANE]: the JAX ``_make_scan_fused`` kernel with ``fused_pack``,
    whose prologue extracts the 8 byte-bit planes from the quad words
    (halo2_regex_tpu/ops/bitplane.py:947-958) for the folded-class step
    circuits."""
    if plan.class_stage:
        raise ValueError("fuse_pack runs with the class stage off")
    bits = torch.stack(_byte_planes([quads[:, m] for m in range(8)]), 1)
    return scan_plain(plan, bits)


def scan_fpack(plan: BitplanePlan, quads: torch.Tensor) -> torch.Tensor:
    """Stage 2 with the in-scan pack, routed by device (module docstring)."""
    if _on_cuda(quads):
        return _kernels().scan_fpack_cuda(plan, quads)
    return scan_fpack_plain(plan, quads)


def scan_def_plain(plan: BitplanePlan, bits_stack: torch.Tensor, d: int) -> torch.Tensor:
    """Def ``d``'s serial scan alone: the scan's input planes [L_pad, KP,
    NWS, LANE] -> its log planes [NWS, sb_d, L_pad, LANE].  The JAX
    ``_make_scan`` kernel (halo2_regex_tpu/ops/bitplane.py:836), which
    ``scan_planes`` runs."""
    return _scan_defs(plan, bits_stack, [d])


def scan_def(plan: BitplanePlan, bits_stack: torch.Tensor, d: int) -> torch.Tensor:
    """One def's scan, routed by device (module docstring)."""
    if _on_cuda(bits_stack):
        return _kernels().scan_def_cuda(plan, bits_stack, d)
    return scan_def_plain(plan, bits_stack, d)


# ---------------------------------------------------------------------------
# Stage 3: post (K3), post_planes (B3 planes mode), fb_only (B4)
# ---------------------------------------------------------------------------


@dataclass
class _Tags:
    per_def: List[Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]]
    ids_sum: List[torch.Tensor]
    start_any: torch.Tensor
    endf_any: torch.Tensor
    fwd: torch.Tensor
    bwd: torch.Tensor
    mask: torch.Tensor


def _tags(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor):
    """Each def's tag circuit on its (prev, next) log planes (ids,
    is_start, is_end, masked by enable) and the id sum across defs:
    (per_def, ids_sum, start_any, endf_any)."""
    zrow = torch.zeros_like(en[:, :1])
    per_def = []
    ids_sum = start_any = endf_any = None
    for d, c in enumerate(plan.circuits):
        nxt = [logs[:, plan.sb_off[d] + j] for j in range(c.sb)]
        prv = [
            _shift_down(nxt[j], torch.full_like(zrow, -1 if plan.first_bit(d, j) else 0))
            for j in range(c.sb)
        ]
        env = {f"prev{j}": prv[j] for j in range(c.sb)}
        env.update({f"next{j}": nxt[j] for j in range(c.sb)})
        tag = c.tag_prog.run(env)
        idp = [tag[f"id{j}"] & en for j in range(plan.idb)]
        stp = tag["is_start"] & en
        efp = tag["is_end"] & en
        per_def.append((idp, stp, efp))
        if ids_sum is None:
            ids_sum, start_any, endf_any = idp, stp, efp
        else:
            ids_sum = plane_add(ids_sum, idp, plan.idb + d.bit_length() + 1)
            start_any = start_any | stp
            endf_any = endf_any | efp
    return per_def, ids_sum, start_any, endf_any


def _fsm_steps(ids_sum: List[torch.Tensor], start_any: torch.Tensor, endf_any: torch.Tensor):
    """Each position's step of the two mask FSMs, x' = (x & hold) | set:
    (hold, set) of the forward FSM (src/lib.rs:598-645) and of the
    backward FSM (src/lib.rs:663-714)."""
    zrow = torch.zeros_like(start_any[:, :1])
    changed = _or_reduce(torch.stack([p ^ _shift_down(p, zrow) for p in ids_sum]), 0)
    prev_endf = _shift_down(endf_any, zrow)
    is_set = start_any & changed
    is_reset = ~start_any & prev_endf & changed
    changed_b = _or_reduce(torch.stack([p ^ _shift_up(p) for p in ids_sum]), 0)
    next_start = _shift_up(start_any)
    set_b = endf_any & changed_b
    reset_b = ~endf_any & next_start & changed_b
    return ~(is_set | is_reset), is_set, ~(set_b | reset_b), set_b


def _tags_and_masks(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> _Tags:
    """The body shared by the post modes: the tags and id sum, and the
    forward/backward mask FSMs as log-scans (the CUDA kernels compose
    them over chunks of L)."""
    per_def, ids_sum, start_any, endf_any = _tags(plan, logs, en)
    hold_f, set_f, hold_b, set_b = _fsm_steps(ids_sum, start_any, endf_any)
    fwd = _fsm_log_scan(hold_f, set_f, reverse=False)
    bwd = _fsm_log_scan(hold_b, set_b, reverse=True)
    return _Tags(per_def, ids_sum, start_any, endf_any, fwd, bwd, fwd & bwd)


def fb_only_plain(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Log planes [NWS, SB, L_pad, LANE] and enable plane [NWS, L_pad,
    LANE] -> final-state boundary planes [NWS, n_defs, 8, LANE]: per def
    the log bits at the last enabled position (the first state for empty
    strings).  The JAX ``_make_fb_only`` kernel; ``post_plain`` emits the
    same planes."""
    NWS = logs.shape[0]
    bnd = en & ~_shift_up(en)  # last enabled position of each string
    empty = ~en[:, 0]  # [NWS, LANE]
    fb = torch.zeros((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=logs.device)
    for d, c in enumerate(plan.circuits):
        for j in range(c.sb):
            x = _or_reduce(bnd & logs[:, plan.sb_off[d] + j], 1)
            fb[:, d, j] = x | empty if plan.first_bit(d, j) else x
    return fb


FB_WORDS, FB_GROUPS, FB_PER = 8, 32, 4  # kWords, kGroups, kPer of csrc/bitplane_fb.cu


def fb_blocks_plain(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """``fb_only_plain``'s function as the B4 kernel (``csrc/bitplane_fb.cu``)
    computes it, for tests (no pipeline calls it): a cluster of CS =
    min(8, ceil(L / 128)) blocks owns 8 words; thread (word wl, group pg)
    of rank k ORs bnd & log over its 4 positions k * 128 + 4 pg + i * CS *
    128 + (0..3); lanes (pg % 4) * 8 + wl of warp pg // 4 meet by the
    shuffle rounds xor 8 and xor 16, lanes 0..7 of the eight warps in
    shared memory, the ranks in rank 0, which adds the empty-string term
    (~en[0] on each first-state bit) and maps log planes to the [n_defs,
    8] slots."""
    NWS, SB, L, _ = logs.shape
    step = FB_GROUPS * FB_PER
    CS = min(8, -(-L // step))
    n_i = -(-L // (CS * step))
    Lp = n_i * CS * step
    dev = logs.device
    e = torch.zeros((NWS, Lp + 1, LANE), dtype=torch.int32, device=dev)
    e[:, :L] = en
    bnd = e[:, :Lp] & ~e[:, 1:]  # thread-local: its positions' enable words and the next
    lg = torch.zeros((NWS, SB, Lp, LANE), dtype=torch.int32, device=dev)
    lg[:, :, :L] = logs
    # l = ((i * CS + rank) * 32 + pg) * 4 + p, pg = 4 warp + lane // 8; word = 8 block + wl
    terms = (bnd[:, None] & lg).reshape(NWS, SB, n_i, CS, 8, 4, FB_PER, LANE // 8, 8)
    acc = _or_reduce(_or_reduce(terms, 6), 2)  # [nws, j, rank, warp, lane // 8, block, wl]
    acc = acc.permute(0, 1, 2, 5, 3, 4, 6).reshape(NWS, SB, CS, LANE // 8, 8, 32)
    lane = torch.arange(32, device=dev)
    for x in (8, 16):
        acc = acc | acc[..., lane ^ x]
    part = _or_reduce(acc[..., :8], 4)  # lanes 0..7 of each warp, then the warps
    allp = _or_reduce(part, 2).reshape(NWS, SB, LANE)  # rank 0 reads every rank's
    empty = ~en[:, 0]
    fb = torch.zeros((NWS, plan.n_defs, 8, LANE), dtype=torch.int32, device=dev)
    for d, c in enumerate(plan.circuits):
        for j in range(c.sb):
            x = allp[:, plan.sb_off[d] + j]
            fb[:, d, j] = x | empty if plan.first_bit(d, j) else x
    return fb


def fb_only(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Stage 3 of match mode, routed by device (see module docstring)."""
    if _on_cuda(logs, en):
        return _kernels().fb_only_cuda(plan, logs, en)
    return fb_only_plain(plan, logs, en)


def post_plain(
    plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor,
    tiled: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log planes [NWS, SB, L_pad, LANE] and enable plane [NWS, L_pad,
    LANE] -> byte-group words [NWS, 8G, L_pad, LANE] and final-state
    boundary planes [NWS, n_defs, 8, LANE]: the JAX ``_make_post`` kernel
    in bytes mode with pre-dummied states.  A tiled plan also takes the
    quad words ``tiled`` [NWS, 8, L_pad, LANE] and emits the masked
    characters: the 8 byte-bit planes of the words ANDed with the mask
    (the JAX tiled mode, halo2_regex_tpu/ops/bitplane.py:1455-1470)."""
    if plan.tiled != (tiled is not None):
        raise ValueError("a tiled plan's post takes the quad words, and only it")
    avail = _emission_planes(plan, _tags_and_masks(plan, logs, en), logs, en, tiled)
    return _group_words(plan.wgroups, avail), fb_only_plain(plan, logs, en)


def _chunks(p: torch.Tensor, CL: int, fill: int) -> torch.Tensor:
    """A plane [NWS, L, LANE] cut into chunks of ``CL`` positions, the last
    padded with ``fill``: [NWS, ceil(L / CL), CL, LANE]."""
    NWS, L, _lane = p.shape
    nch = -(-L // CL)
    pad = torch.full((NWS, nch * CL - L, LANE), fill, dtype=p.dtype, device=p.device)
    return torch.cat([p, pad], 1).reshape(NWS, nch, CL, LANE)


def _chunked_masks(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor, CL: int) -> _Tags:
    """``_tags_and_masks`` with the mask FSMs computed as
    ``csrc/bitplane_post.cu`` computes them over chunks of ``CL`` positions
    (the last chunk padded with identity steps).  A: each chunk's forward
    map, composed ascending, and its backward map; B: each chunk's
    carry-in x (the forward maps before it applied to 0) and y (the
    backward maps after it); C: each chunk replayed from its carry-ins, x
    ascending and y descending."""
    per_def, ids_sum, start_any, endf_any = _tags(plan, logs, en)
    NWS, L, _lane = en.shape
    nch = -(-L // CL)
    hf, sf, hb, sb = (_chunks(p, CL, f) for p, f in zip(
        _fsm_steps(ids_sum, start_any, endf_any), (-1, 0, -1, 0)))
    # A: the maps of each chunk
    fh, fs = torch.full_like(hf[:, :, 0], -1), torch.zeros_like(sf[:, :, 0])
    bh, bs = fh.clone(), fs.clone()
    for i in range(CL):
        fs = (fs & hf[:, :, i]) | sf[:, :, i]
        fh = fh & hf[:, :, i]
        bs = (sb[:, :, i] & bh) | bs  # the maps above it after step i
        bh = bh & hb[:, :, i]
    # B: the carry-ins, composed across chunks
    x_in, y_in = [], [None] * nch
    x = y = torch.zeros_like(fs[:, 0])
    for c in range(nch):
        x_in.append(x)
        x = (x & fh[:, c]) | fs[:, c]
    for c in range(nch - 1, -1, -1):
        y_in[c] = y
        y = (y & bh[:, c]) | bs[:, c]
    # C: the replay
    x, y = torch.stack(x_in, 1), torch.stack(y_in, 1)
    fwd, bwd = [], [None] * CL
    for i in range(CL):
        x = (x & hf[:, :, i]) | sf[:, :, i]
        fwd.append(x)
    for i in range(CL - 1, -1, -1):
        y = (y & hb[:, :, i]) | sb[:, :, i]
        bwd[i] = y
    fwd = torch.stack(fwd, 2).reshape(NWS, nch * CL, LANE)[:, :L]
    bwd = torch.stack(bwd, 2).reshape(NWS, nch * CL, LANE)[:, :L]
    return _Tags(per_def, ids_sum, start_any, endf_any, fwd, bwd, fwd & bwd)


def post_chunks_plain(
    plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor, CL: int,
    tiled: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked post kernel's phases in torch ops, for tests (no
    pipeline calls it): ``post_plain``'s contract, with the mask FSMs of
    ``_chunked_masks``.  The boundary planes are ORed per chunk, then
    across chunks (the kernel's atomicOr)."""
    if plan.tiled != (tiled is not None):
        raise ValueError("a tiled plan's post takes the quad words, and only it")
    t = _chunked_masks(plan, logs, en, CL)
    g4 = _group_words(plan.wgroups, _emission_planes(plan, t, logs, en, tiled))
    # the boundary planes: per chunk an OR over its positions, then across
    bnd = _chunks(en & ~_shift_up(en), CL, 0)
    fb = torch.zeros((en.shape[0], plan.n_defs, 8, LANE), dtype=torch.int32, device=logs.device)
    for d, c in enumerate(plan.circuits):
        for j in range(c.sb):
            part = _or_reduce(bnd & _chunks(logs[:, plan.sb_off[d] + j], CL, 0), 2)
            x = _or_reduce(part, 1)
            fb[:, d, j] = x | ~en[:, 0] if plan.first_bit(d, j) else x
    return g4, fb


def _emission_planes(plan: BitplanePlan, t: _Tags, logs: torch.Tensor, en: torch.Tensor,
                     tiled: Optional[torch.Tensor] = None) -> Dict[str, List[torch.Tensor]]:
    """The witness fields' planes of the bytes, kdecode and direct
    emissions: flags, masked ids, each def's states with its dummy state
    spliced in where enable is off, and (tiled) the masked characters."""
    avail: Dict[str, List[torch.Tensor]] = {
        "flags": [t.mask, t.fwd, t.bwd, en, t.start_any, t.endf_any],
        "masked_idsum": [p & t.mask for p in t.ids_sum],
    }
    for d, c in enumerate(plan.circuits):
        planes = []
        for j in range(c.sb):
            p = logs[:, plan.sb_off[d] + j] & en
            if (plan.dummy_states[d] >> j) & 1:
                p = p | ~en
            planes.append(p)
        avail[f"states{d}"] = planes
    if tiled is not None:
        avail["masked_characters_pre"] = [
            p & t.mask for p in _byte_planes([tiled[:, m] for m in range(8)])]
    return avail


def _l4_rows(words: torch.Tensor) -> torch.Tensor:
    """Byte-lane words [..., L_pad, LANE] int32 -> the string-major
    l4-packed rows [..., 4 * LANE, L_pad / 4] int32: row 4 * lane + s holds
    byte lane s of word ``lane``, byte l % 4 of column l / 4 is position l
    (the in-VMEM transpose of the JAX direct and decode kernels,
    halo2_regex_tpu/ops/bitplane.py:1476-1492, :1671-1682)."""
    *lead, L_pad, _lane = words.shape
    u8 = words.contiguous().reshape(-1).view(torch.uint8).reshape(*lead, L_pad, LANE, 4)
    rows = u8.movedim(-3, -1).reshape(*lead, 4 * LANE, L_pad).contiguous()
    return rows.reshape(-1).view(torch.int32).reshape(*lead, 4 * LANE, L_pad // 4)


def post_direct_plain(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Log planes and enable plane -> one l4-packed string-major array per
    field of ``dfields``, stacked [n_fields, 8, NWS, 4 * LANE, L_pad / 4]
    int32: row (m, nws, 4 * lane + s) is string 4 * (w + NW * m) + s, so
    each field's [B, L_pad] uint8 column is a view.  The JAX ``_make_post``
    kernel in direct mode (pre-dummied states, no boundary planes)."""
    return _direct_rows(plan, _tags_and_masks(plan, logs, en), logs, en)


def post_direct_chunks_plain(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor,
                             CL: int) -> torch.Tensor:
    """The chunked post kernel's direct mode in torch ops, for tests (no
    pipeline calls it): ``post_direct_plain``'s contract, with the mask
    FSMs of ``_chunked_masks`` over chunks of ``CL`` positions (launches A
    and B, and C's replay; C writes each chunk's columns of the rows, which
    ``_l4_rows`` lays out here at once)."""
    return _direct_rows(plan, _chunked_masks(plan, logs, en, CL), logs, en)


def _direct_rows(plan: BitplanePlan, t: _Tags, logs: torch.Tensor, en: torch.Tensor
                 ) -> torch.Tensor:
    """The direct emission of the tags and masks ``t`` (``post_direct_plain``)."""
    avail = _emission_planes(plan, t, logs, en)
    out = []
    for name, _nb in plan.dfields:
        planes = avail[name] + [torch.zeros_like(en)] * (8 - len(avail[name]))
        out.append(_l4_rows(transpose8(torch.stack(planes))))  # [8m, NWS, 512, l4]
    return torch.stack(out)


def post_direct(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Stage 3 of the direct witness emission, routed by device."""
    if _on_cuda(logs, en):
        return _kernels().post_direct_cuda(plan, logs, en)
    return post_direct_plain(plan, logs, en)


def decode_plain(plan: BitplanePlan, g4: torch.Tensor, ch_l4: torch.Tensor) -> torch.Tensor:
    """Byte-group words [NWS, 8G, L_pad, LANE] and the chars as l4-packed
    int32 [B, L_pad / 4] -> every byte-group field as a string-major
    l4-packed array, then the masked characters: [n_fields + 1, B,
    L_pad / 4] int32.  Row 512 * (b * NWS + nws) + 4 * lane + s is string
    4 * (w + NW * b) + s.  Field (group gi, first bit off, nb bits) is
    (word >> off) & ((2^nb - 1) * 0x01010101) of group word b; the masked
    characters are chars & 0xFF in every byte whose flags bit 0 (the mask)
    is set.  The JAX ``_make_decode`` kernel (B14)."""
    NWS, _g8, L_pad, _lane = g4.shape
    g = g4.reshape(NWS, plan.n_groups, 8, L_pad, LANE)
    out = []
    for _name, gi, off, nb in plan.fields_flat:
        v = (g[:, gi] >> off) & (((1 << nb) - 1) * _QUAD_MASK)
        out.append(_l4_rows(v.movedim(1, 0)).reshape(ch_l4.shape))
    m = out[0] & _QUAD_MASK  # flags, bit 0 of each byte
    m = m | (m << 1)
    m = m | (m << 2)
    out.append(ch_l4 & (m | (m << 4)))
    return torch.stack(out)


def decode(plan: BitplanePlan, g4: torch.Tensor, ch_l4: torch.Tensor) -> torch.Tensor:
    """The kdecode emission's decode (B14), routed by device."""
    if _on_cuda(g4, ch_l4):
        return _kernels().decode_cuda(plan, g4, ch_l4)
    return decode_plain(plan, g4, ch_l4)


def post(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor,
         tiled: Optional[torch.Tensor] = None):
    """Stage 3 of witness mode, routed by device (see module docstring);
    a tiled plan launches the post kernel's tiled mode."""
    given = [x for x in (logs, en, tiled) if x is not None]
    if _on_cuda(*given):
        if tiled is not None:
            return _kernels().post_tiled_cuda(plan, logs, en, tiled)
        return _kernels().post_cuda(plan, logs, en)
    return post_plain(plan, logs, en, tiled)


def post_xla(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor
             ) -> Dict[str, List[torch.Tensor]]:
    """Log planes and enable plane -> every named plane list of the post
    stage: per def ids/start/endf, idsum, masked_idsum, fwd, bwd, mask,
    start_any, endf_any.  The JAX ``_post_xla``
    (halo2_regex_tpu/ops/bitplane.py:379-455): XLA there, torch ops on
    any device here (``post="xla"``; no kernel)."""
    t = _tags_and_masks(plan, logs, en)
    named: Dict[str, List[torch.Tensor]] = {
        "idsum": t.ids_sum,
        "masked_idsum": [p & t.mask for p in t.ids_sum],
        "fwd": [t.fwd],
        "bwd": [t.bwd],
        "mask": [t.mask],
        "start_any": [t.start_any],
        "endf_any": [t.endf_any],
    }
    for d, (idp, stp, efp) in enumerate(t.per_def):
        named.update({f"ids{d}": idp, f"start{d}": [stp], f"endf{d}": [efp]})
    return named


def post_planes_plain(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Log planes and enable plane -> the named planes of ``post_off``
    [NWS, P_total, L_pad, LANE]: for a full plan per def ids/start/endf,
    then idsum, masked_idsum, fwd, bwd, mask; for a witness plan
    masked_idsum, fwd, bwd, mask, start_any, endf_any.  The JAX
    ``_make_post`` kernel in planes mode (no byte groups, no ``fb``, no
    dummy splice)."""
    named = post_xla(plan, logs, en)
    return torch.stack([p for name in plan.post_off for p in named[name]], 1)


def post_planes(plan: BitplanePlan, logs: torch.Tensor, en: torch.Tensor) -> torch.Tensor:
    """Stage 3 of full mode, routed by device (see module docstring)."""
    if _on_cuda(logs, en):
        return _kernels().post_planes_cuda(plan, logs, en)
    return post_planes_plain(plan, logs, en)


# ---------------------------------------------------------------------------
# Stage 4: decode + finish (plain torch on every device)
# ---------------------------------------------------------------------------


def _group_words(groups, avail: Dict[str, List[torch.Tensor]]) -> torch.Tensor:
    """Each <= 8-plane group of named planes [NWS, L_pad, LANE] -> its 8
    byte-lane words (SWAR transpose, zero planes above the last field):
    [NWS, 8G, L_pad, LANE]."""
    words = []
    for grp in groups:
        planes = [p for name, _off, _nb in grp for p in avail[name]]
        planes += [torch.zeros_like(planes[0])] * (8 - len(planes))
        words.append(transpose8(torch.stack(planes)))
    return torch.cat(words).movedim(0, 1)


def decode_groups(g4: torch.Tensor, groups, L: int) -> Dict[str, torch.Tensor]:
    """Byte-group words [NWS, 8G, L_pad, LANE] -> each field's uint8
    values as a [8, NWS, LANE, 4, L] view, whose flat order is the string
    order: byte lane s of word (nws, lane) in group word b is string
    4*(w + NW*b) + s.  The transpose to string-major runs on int32 words
    first (one pass over all groups), then on each field's byte lanes: on
    the H100 that is 1.9x faster than one byte-level transpose per field."""
    NWS, _g8, L_pad, _lane = g4.shape
    G = len(groups)
    words = g4.reshape(NWS, G, 8, L_pad, LANE)[:, :, :, :L]
    words = words.permute(1, 2, 0, 4, 3).contiguous()  # [G, b, nws, lane, L]
    # int32 -> 4 uint8 lanes: torch widens the last dim instead of adding
    # an axis, so split it back out
    u8 = words.reshape(-1).view(torch.uint8).reshape(G, 8, NWS, LANE, L, 4)
    out = {}
    for gi, grp in enumerate(groups):
        arr = u8[gi]  # [b, nws, lane, L, s]
        for k, (name, off, nb) in enumerate(grp):
            v = arr >> off if off else arr
            if k + 1 < len(grp):  # the transpose zero-fills the bits above
                v = v & ((1 << nb) - 1)  # a group's last field
            out[name] = v.permute(0, 1, 2, 4, 3)  # [b, nws, lane, s, L]
    return out


def decode_bytes(
    plan: BitplanePlan, g4: torch.Tensor, B: int, first_states: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Witness byte-group words -> [B, L] uint8 field columns, plus
    ``states`` [B, n_defs, L+1]: each def's first state, then its states
    field, written in place."""
    L = plan.L
    states = torch.empty((B, plan.n_defs, L + 1), dtype=torch.uint8, device=g4.device)
    states[:, :, 0] = first_states.to(torch.uint8)
    vals = {"states": states}
    for name, v in decode_groups(g4, plan.wgroups, L).items():
        if name.startswith("states"):
            d = int(name[len("states"):])
            states[:, d, 1:].view(v.shape).copy_(v)
        else:
            vals[name] = v.reshape(B, L)
    return vals


def unpack_groups(
    named: List[Tuple[str, List[torch.Tensor]]], L: int
) -> Dict[str, torch.Tensor]:
    """Named plane vectors [NWS, L_pad, LANE] -> [B, L] values (the JAX
    ``unpack_groups``, halo2_regex_tpu/ops/bitplane.py:266): uint8 for a
    field of <= 8 planes, int32 above.  Fields pack greedily into <= 8-bit
    groups; each group is one SWAR transpose into byte-lane words and one
    ``decode_groups`` pass, with no 32x bit-expanded intermediate.  A field
    wider than 8 planes is split into byte-wide parts and reassembled."""
    parts, avail = [], {}
    for name, planes in named:
        for k in range(0, len(planes), 8):
            avail[(name, k)] = planes[k : k + 8]
            parts.append(((name, k), len(avail[(name, k)])))
    groups = _byte_groups(parts)
    g4 = _group_words(groups, avail)
    B = g4.shape[0] * TILE
    vals = {key: v.reshape(B, L) for key, v in decode_groups(g4, groups, L).items()}
    out = {}
    for name, planes in named:
        if len(planes) <= 8:
            out[name] = vals[(name, 0)]
        else:
            out[name] = sum(vals[(name, k)].to(torch.int32) << k
                            for k in range(0, len(planes), 8))
    return out


def final_from_fb(fb: torch.Tensor, B: int) -> torch.Tensor:
    """[NWS, n_defs, 8, LANE] boundary planes -> final states [B, n_defs]
    int32 (bit beta = 8s+m of word w is string 4*(w + NW*m) + s)."""
    NW = B // 32
    n_defs = fb.shape[1]
    beta = torch.arange(32, dtype=torch.int32, device=fb.device)
    bits = (fb[..., None] >> beta) & 1  # [NWS, n_defs, 8, LANE, 32]
    shifts = torch.arange(8, dtype=torch.int32, device=fb.device)
    vals = (bits << shifts[None, None, :, None, None]).sum(2, dtype=torch.int32)
    cols = [
        vals[:, d].reshape(NW, 4, 8).permute(2, 0, 1).reshape(B)
        for d in range(n_defs)
    ]
    return torch.stack(cols, 1)


def _verdicts(tables: Dict[str, torch.Tensor], final: torch.Tensor):
    """Final states [B, n_defs] -> accepted, has_dead, match_ok."""
    d_idx = torch.arange(final.shape[1], device=final.device)[None, :]
    accepted = tables["accept_mask"][d_idx, final.long()]
    has_dead = final == tables["dead_states"][None, :]
    return accepted, has_dead, accepted.all(1) & ~has_dead.any(1)


def finish_match(
    tables: Dict[str, torch.Tensor], fb: torch.Tensor, B: int, B_orig: int
) -> Dict[str, torch.Tensor]:
    """The verdict dict of the JAX ``_finish_match``: ``final_states``
    [B, n_defs] int32, ``accepted``, ``has_dead``, ``match_ok``."""
    final = final_from_fb(fb, B)
    accepted, has_dead, match_ok = _verdicts(tables, final)
    out = dict(final_states=final, accepted=accepted, has_dead=has_dead,
               match_ok=match_ok)
    return {k: v[:B_orig] for k, v in out.items()}


def decode_columns(plan: BitplanePlan, cols: torch.Tensor, names, B: int
                   ) -> Dict[str, torch.Tensor]:
    """l4-packed string-major arrays (each [B, L_pad / 4] int32 in memory:
    ``post_direct``'s or ``decode``'s rows) -> each named field's [B, L]
    uint8 column, a view of the array's bytes."""
    L = plan.L
    u8 = cols.reshape(-1).view(torch.uint8).reshape(len(names), B, plan.L_pad)
    return {name: u8[i, :, :L] for i, name in enumerate(names)}


def states_column(tables: Dict[str, torch.Tensor], vals: Dict[str, torch.Tensor],
                  n_defs: int) -> torch.Tensor:
    """Each def's [B, L] states field -> the [B, n_defs, L + 1] states
    column, the first state in column 0 (JAX :2024-2032)."""
    after = torch.stack([vals[f"states{d}"] for d in range(n_defs)], 1)
    B = after.shape[0]
    first = tables["first_states"].to(after.dtype)[None, :, None].expand(B, n_defs, 1)
    return torch.cat([first, after], 2)


def finish_witness(
    tables: Dict[str, torch.Tensor],
    vals: Dict[str, torch.Tensor],
    fb: Optional[torch.Tensor],
    B: int,
    B_orig: int,
    chars: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    predummied: bool = True,
) -> Dict[str, torch.Tensor]:
    """The compact witness dict of the JAX ``_finish_witness``
    (halo2_regex_tpu/ops/bitplane.py:1979-2075).  ``vals["states"]`` is
    the [B, n_defs, L + 1] states column with the first state in column 0;
    unless ``predummied`` (the post stage spliced the dummy state in), the
    dummy state replaces every column past each string's length here.  The
    final states come from the boundary planes ``fb`` when the post kernel
    emitted them, else from the states column at each length.  The masked
    characters are ``mask * chars``, or the ``masked_characters_pre``
    field of the tiled post kernel or of the decode kernel."""
    flags = vals["flags"]
    mask = flags & 1
    raw = vals["states"]
    states = raw
    if not predummied:
        L1 = raw.shape[2]
        in_range = (torch.arange(L1, dtype=torch.int32, device=raw.device)[None, None, :]
                    <= lengths[:, None, None])
        dummy = tables["dummy_states"].to(raw.dtype)[None, :, None]
        states = torch.where(in_range, raw, dummy)
    if fb is not None:
        final = final_from_fb(fb, B)
    else:
        idx = lengths.long()[:, None, None].expand(B, raw.shape[1], 1)
        final = torch.gather(raw, 2, idx)[:, :, 0].to(torch.int32)
    accepted, has_dead, match_ok = _verdicts(tables, final)
    masked = vals.get("masked_characters_pre")
    out = dict(
        states=states,
        all_substr_ids=vals["masked_idsum"],
        masked_characters=mask * chars if masked is None else masked,
        flags=flags,
        mask=mask,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=match_ok,
    )
    return {k: v[:B_orig] for k, v in out.items()}


def finish_full(
    plan: BitplanePlan,
    tables: Dict[str, torch.Tensor],
    chars: torch.Tensor,
    lengths: torch.Tensor,
    planes: Dict[str, List[torch.Tensor]],
    logs: torch.Tensor,
    B_orig: int,
) -> RegexResult:
    """The full ``RegexResult`` of the JAX ``_finish_full``
    (halo2_regex_tpu/ops/bitplane.py:2077) from the post stage's named
    planes (``planes_of`` or ``post_xla``): states come from the raw log
    planes (not pre-dummied), with the dummy state past each length and
    the final state read at the length."""
    B, L = chars.shape
    dev = chars.device
    val_dtype = torch.uint8 if plan.compact else torch.int32

    named = [(name, planes[name]) for name in ("idsum", "masked_idsum", "fwd", "bwd", "mask")]
    for d, c in enumerate(plan.circuits):
        named.append((f"states{d}", [logs[:, plan.sb_off[d] + j] for j in range(c.sb)]))
        named += [(f"{f}{d}", planes[f"{f}{d}"]) for f in ("ids", "start", "endf")]
    vals = unpack_groups(named, L)

    pos = torch.arange(L, dtype=torch.int32, device=dev)
    enable = (pos[None, :] < lengths[:, None]).to(val_dtype)
    chars_v = chars.to(val_dtype) * enable
    mask = vals["mask"].to(val_dtype)
    sum_dtype = val_dtype if plan.nsum <= 8 else torch.int32
    s_pad = tables["accept_mask"].shape[1]
    st_dtype = val_dtype if s_pad <= 255 else torch.int32

    ids_list, start_list, end_list = [], [], []
    for d in range(plan.n_defs):
        ids_list.append(vals[f"ids{d}"].to(val_dtype))
        start_list.append(vals[f"start{d}"].to(val_dtype))
        end_list.append(vals[f"endf{d}"].to(val_dtype))
    start_sum, end_sum = sum(start_list), sum(end_list)

    after = torch.stack([vals[f"states{d}"].to(st_dtype) for d in range(plan.n_defs)], 1)
    first = tables["first_states"].to(st_dtype)[None, :, None].expand(B, plan.n_defs, 1)
    raw = torch.cat([first, after], 2)  # [B, n_defs, L + 1]
    posL1 = torch.arange(L + 1, dtype=torch.int32, device=dev)
    in_range = posL1[None, None, :] <= lengths[:, None, None]
    dummy = tables["dummy_states"].to(st_dtype)[None, :, None]
    states = torch.where(in_range, raw, dummy)
    idx = lengths.long()[:, None, None].expand(B, plan.n_defs, 1)
    final = torch.gather(raw, 2, idx)[:, :, 0].to(torch.int32)
    accepted, has_dead, match_ok = _verdicts(tables, final)

    zcol = torch.zeros((B, 1), dtype=start_sum.dtype, device=dev)
    out = dict(
        all_enable_flags=enable,
        all_characters=chars_v,
        all_substr_ids=vals["masked_idsum"].to(sum_dtype),
        masked_characters=mask * chars_v,
        states=states,
        substr_ids_per_def=torch.stack(ids_list, 1),
        start_enable=torch.stack(start_list, 1),
        end_enable=torch.stack(end_list, 1),
        is_start_sum=torch.cat([start_sum, zcol], 1),
        is_end_sum=torch.cat([zcol, end_sum], 1),
        substr_id_sum=vals["idsum"].to(sum_dtype),
        fwd_mask=vals["fwd"].to(val_dtype),
        bwd_mask=vals["bwd"].to(val_dtype),
        mask=mask,
        accepted=accepted,
        has_dead=has_dead,
        match_ok=match_ok,
    )
    return RegexResult(**{k: v[:B_orig] for k, v in out.items()})


def run(
    plan: BitplanePlan,
    tables: Dict[str, torch.Tensor],
    chars: torch.Tensor,
    lengths: torch.Tensor,
    plain: bool = False,
):
    """The whole pipeline of ``plan.columns`` on ``chars`` [B, L] uint8 and
    ``lengths`` [B] int32 (both on the device that runs it).  The batch is
    padded to a multiple of 32*LANE strings and the outputs sliced back.
    A tiled plan takes the quad words [NWS, 8, L_pad, LANE] int32 of
    ``tile_corpus`` as ``chars`` (B = NWS*32*LANE) and ``lengths`` of at
    most B strings (the rest read as empty and are sliced off).  ``plain``
    runs the plain version of every stage on any device (the reference the
    kernels are held against); otherwise stages route by device."""
    if plan.tiled:
        return _run_tiled(plan, tables, chars, lengths, plain)
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
    len_wb = len_table(lengths)
    if plan.fuse_pack:  # the scan extracts the byte planes itself
        logs = (scan_fpack_plain if plain else scan_fpack)(plan, raw_quads(chars, plan.L_pad))
        en = None
    else:
        if plan.qpack:
            bits_stack, en = (qpack_plain if plain else qpack)(plan, chars, len_wb)
        else:
            quads = raw_quads(chars, plan.L_pad)
            bits_stack, en = (pack_plain if plain else pack)(plan, quads, len_wb)
        logs = (scan_plain if plain else scan)(plan, bits_stack)
    if en is None:  # en_pack off: the JAX matcher's XLA pass, torch ops here
        en = enable_plane(len_wb, plan.L_pad)
    if plan.columns == "match":
        fb = (fb_only_plain if plain else fb_only)(plan, logs, en)
        return finish_match(tables, fb, B, B_orig)
    if plan.columns == "witness":
        return _witness_tail(plan, tables, logs, en, chars, lengths, B, B_orig, plain)
    if plan.post == "xla":
        planes = post_xla(plan, logs, en)
    else:
        planes = planes_of(plan, (post_planes_plain if plain else post_planes)(plan, logs, en))
    return finish_full(plan, tables, chars, lengths, planes, logs, B_orig)


def planes_of(plan: BitplanePlan, post_out: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
    """The planes-mode post output [NWS, P_total, L_pad, LANE] -> its
    named plane lists (``post_off``)."""
    return {name: [post_out[:, o + j] for j in range(nb)]
            for name, (o, nb) in plan.post_off.items()}


def _witness_tail(plan, tables, logs, en, chars, lengths, B, B_orig, plain):
    """The witness emission of ``plan.emit`` (the JAX ``_post_decode`` and
    ``_finish_witness``, halo2_regex_tpu/ops/bitplane.py:1892-2075)."""
    if plan.emit in ("bytes", "kdecode"):
        g4, fb = (post_plain if plain else post)(plan, logs, en)
        if plan.emit == "bytes":
            vals = decode_bytes(plan, g4, B, tables["first_states"])
            return finish_witness(tables, vals, fb, B, B_orig, chars)
        # the decode kernel emits every field and the masked characters
        ch = chars if plan.L_pad == plan.L else torch.cat(
            [chars, chars.new_zeros((B, plan.L_pad - plan.L))], 1)
        ch_l4 = ch.contiguous().reshape(-1).view(torch.int32).reshape(B, plan.l4)
        cols = (decode_plain if plain else decode)(plan, g4, ch_l4)
        names = [name for name, *_ in plan.fields_flat] + ["masked_characters_pre"]
        vals = decode_columns(plan, cols, names, B)
        vals["states"] = states_column(tables, vals, plan.n_defs)
        return finish_witness(tables, vals, fb, B, B_orig, chars)
    if plan.emit == "direct":  # no boundary planes: final from the states
        cols = (post_direct_plain if plain else post_direct)(plan, logs, en)
        vals = decode_columns(plan, cols, [name for name, _nb in plan.dfields], B)
        vals["states"] = states_column(tables, vals, plan.n_defs)
        return finish_witness(tables, vals, None, B, B_orig, chars, lengths)
    # planes: the post kernel's named planes, or torch ops for post="xla";
    # states from the raw log planes, not pre-dummied (JAX :1984-2014)
    if plan.post == "xla":
        planes = post_xla(plan, logs, en)
    else:
        planes = planes_of(plan, (post_planes_plain if plain else post_planes)(plan, logs, en))
    named = [("flags", planes["mask"] + planes["fwd"] + planes["bwd"] + [en]
              + planes["start_any"] + planes["endf_any"]),
             ("masked_idsum", planes["masked_idsum"])]
    named += [(f"states{d}", [logs[:, plan.sb_off[d] + j] for j in range(c.sb)])
              for d, c in enumerate(plan.circuits)]
    vals = unpack_groups(named, plan.L)
    vals["states"] = states_column(tables, vals, plan.n_defs)
    return finish_witness(tables, vals, None, B, B_orig, chars, lengths, predummied=False)


def _run_tiled(plan, tables, tiled, lengths, plain):
    """``run`` for the pretiled input contract (the JAX ``_core_tiled``,
    halo2_regex_tpu/ops/bitplane.py:1831-1870): B6 tpack, the scan, then
    the post kernel's tiled mode (witness) or fb_only (match)."""
    shape = tuple(tiled.shape)
    if len(shape) != 4 or shape[1:] != (8, plan.L_pad, LANE) or tiled.dtype != torch.int32:
        raise ValueError(f"tiled input {shape} {tiled.dtype}: expected int32 "
                         f"[NWS, 8, {plan.L_pad}, {LANE}] (see tile_corpus)")
    B = shape[0] * TILE
    B_orig = lengths.shape[0]
    if lengths.dim() != 1 or B_orig > B:
        raise ValueError(f"lengths {tuple(lengths.shape)}: expected at most {B} strings")
    if B_orig != B:
        lengths = torch.cat([lengths, lengths.new_zeros((B - B_orig,))])
    len_wb = len_table(lengths)
    bits_stack, en = (tpack_plain if plain else tpack)(plan, tiled, len_wb)
    logs = (scan_plain if plain else scan)(plan, bits_stack)
    if plan.columns == "match":
        fb = (fb_only_plain if plain else fb_only)(plan, logs, en)
        return finish_match(tables, fb, B, B_orig)
    g4, fb = (post_plain if plain else post)(plan, logs, en, tiled)
    vals = decode_bytes(plan, g4, B, tables["first_states"])
    return finish_witness(tables, vals, fb, B, B_orig)


# ---------------------------------------------------------------------------
# The matcher
# ---------------------------------------------------------------------------


class BitplaneMatcher(nn.Module):
    """Bit-sliced matcher (port of the JAX ``BitplaneMatcher``).

    ``columns`` selects what a call returns, as in the JAX package:
    ``"full"`` (the default) a ``RegexResult`` with every witness column
    (uint8 columns, or int32 with ``compact=False``); ``"witness"`` the
    dict of ``_finish_witness`` (states, all_substr_ids,
    masked_characters, flags, mask, accepted, has_dead, match_ok);
    ``"match"`` the dict of ``_finish_match`` (final_states, accepted,
    has_dead, match_ok).  The model's tables are registered buffers and
    follow ``.to(device)``.  ``device="cuda"``, the default, runs the CUDA
    kernels and raises where CUDA is absent; ``device="cpu"`` runs their
    plain versions.

    Args mirror the JAX constructor, less ``lc`` and ``max_step_ops``
    (TPU tile and VMEM limits).  The knobs (``class_stage``, ``unroll``,
    ``fuse_pack``, ``en_pack``, ``qpack``, ``emit`` and their ``H2R_*``
    variables) resolve and validate as in JAX (:class:`.knobs.BitplaneKnobs`),
    and every value the JAX matcher accepts runs, with the JAX outputs:
    the class stage picks the pack's planes, ``fuse_pack`` the in-scan
    pack (``scan_fpack``), ``en_pack=False`` the enable plane from torch
    ops, ``qpack`` the pack from bytes (K1) or from raw quad rows (B5,
    which any L whose L_pad differs from L takes anyway), ``emit`` the
    witness tail (bytes, kdecode, direct or planes; planes whenever a
    witness field is wider than 8 bits).  ``post="kernel"`` (or JAX's
    ``"pallas"``) runs the fused post kernel, ``"xla"`` the same function
    as torch ops.  ``input_layout="tiled"`` (with ``columns="witness"`` or
    ``"match"``) takes the pretiled quad words of ``tile_corpus(chars,
    matcher.L_pad)`` [NWS, 8, L_pad, LANE] int32 in place of the [B, L]
    chars, and lengths for at most NWS*32*LANE strings; the pack is then B6
    and the witness emission assembles the masked characters in the post
    kernel.  ``scan_planes`` runs one def's scan alone (B7).
    """

    def __init__(
        self,
        model: CompiledRegexModel,
        compact: bool = True,
        post: str = "kernel",
        columns: str = "full",
        class_stage=None,
        unroll: Optional[int] = None,
        fuse_pack: Optional[bool] = None,
        en_pack: Optional[bool] = None,
        qpack: Optional[bool] = None,
        emit: Optional[str] = None,
        input_layout: str = "bl",
        device="cuda",
    ):
        super().__init__()
        if columns not in COLUMNS:
            raise ValueError(f"columns={columns!r}: expected full/witness/match")
        if input_layout not in ("bl", "tiled"):
            raise ValueError(f"input_layout={input_layout!r}: expected bl/tiled")
        tiled = input_layout == "tiled"
        if tiled and columns == "full":  # halo2_regex_tpu/ops/bitplane.py:545-555
            raise ValueError(
                "input_layout='tiled' supports columns='witness'/'match' only: the full "
                "RegexResult set emits all_characters, which needs the string-major "
                "[B, L] chars")
        if post not in ("kernel", "pallas", "xla"):
            raise ValueError(f"post={post!r}: expected kernel (or its JAX name pallas) "
                             "or xla")
        post = "xla" if post == "xla" else "pallas"
        if tiled and columns == "witness" and post != "pallas":
            raise ValueError("input_layout='tiled' witness emission requires "
                             "the fused post kernel (post='kernel')")
        knobs = BitplaneKnobs.from_env(
            unroll=unroll, fuse_pack=fuse_pack, class_stage=class_stage,
            en_pack=en_pack, qpack=qpack, emit=emit,
        )
        self.model = model
        self.knobs = knobs
        self.plan = make_plan(model, columns, compact=compact, tiled=tiled, knobs=knobs,
                              post=post, unroll=scan_unroll(knobs, unroll))
        self.register_buffer(
            "accept_mask", torch.from_numpy(np.asarray(model.accept_mask, bool))
        )
        for name in ("first_states", "dead_states", "dummy_states"):
            self.register_buffer(
                name, torch.from_numpy(np.asarray(getattr(model, name), np.int64))
            )
        self.to(resolve_device(device))

    @property
    def columns(self) -> str:
        return self.plan.columns

    @property
    def input_layout(self) -> str:
        return "tiled" if self.plan.tiled else "bl"

    @property
    def L_pad(self) -> int:
        """Rows of every plane: the ``L_pad`` that ``tile_corpus`` takes."""
        return self.plan.L_pad

    @property
    def device(self) -> torch.device:
        return self.accept_mask.device

    def tables(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    @torch.no_grad()
    def forward(self, chars, lengths):
        dtype = torch.int32 if self.plan.tiled else torch.uint8
        chars = torch.as_tensor(chars, dtype=dtype, device=self.device)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=self.device)
        return run(self.plan, self.tables(), chars.contiguous(), lengths.contiguous())

    @torch.no_grad()
    def scan_planes(self, bits_stack, d: int = 0) -> torch.Tensor:
        """Run def ``d``'s sequential scan alone (B7, ``scan_def``) on a
        prepared plane stack [L_pad, KP, NWS, 128] int32: the pack's
        output, i.e. the concatenated class planes, or the 8 byte-bit
        planes when the class stage is off.  Returns def d's log planes
        [NWS, sb_d, L_pad, 128], the slice ``sb_off[d]`` of the fused
        scan's output (the JAX profiling hook of the same name)."""
        if not 0 <= d < self.plan.n_defs:
            raise ValueError(f"d={d}: the model has {self.plan.n_defs} defs")
        bits = torch.as_tensor(bits_stack, dtype=torch.int32, device=self.device)
        return scan_def(self.plan, bits.contiguous(), d)

    def match_one(self, characters: bytes):
        buf = np.zeros((1, self.plan.L), np.uint8)
        buf[0, : len(characters)] = bytearray(characters)
        if self.plan.tiled:
            buf = tile_corpus(buf, self.plan.L_pad)
        out = self(buf, np.array([len(characters)], np.int32))
        if isinstance(out, RegexResult):
            return out.map(lambda v: v[0].cpu().numpy())
        return {k: v[0].cpu().numpy() for k, v in out.items()}
