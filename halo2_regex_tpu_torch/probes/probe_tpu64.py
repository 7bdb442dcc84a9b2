"""tools/probe_tpu64.py's Pallas probes on the H100: the transpose
primitives at the decode's block shapes, the witness decode on the
tensor cores, and qpack alone.

- ``field_decode(g4, ch_l4, fields, form)``: byte-group words g4 [NWS,
  8G, L, 128] int32 and the chars as l4-packed int32 ch_l4 [B, L/4] (B =
  NWS * 4096) -> [n_fields + 1, B, L/4] int32: each field (group gi, first
  bit off, nb bits; field 0 the flags) as a string-major l4-packed array,
  then the masked characters (chars where the flags' bit 0 is set).  The
  contract of B14's ``ops.bitplane.decode_plain``, with the fields given
  at the call (``fields_of(plan)``).  ``form``: ``"mma_pack"`` (the
  probe's make_mxdecode: ``l4_pack``'s transpose by the packing matrix on
  the tensor cores), ``"mma_select"`` (probe_tpu68's "mx", the selector)
  or ``"swap"`` (probe_tpu68's "sw": the int32 tile transpose, then a
  four-column pack).  Every form gives the same words; L is a multiple of
  64 on the card.

The script's sections: A at X [NBLK=64, 1024, 128] (values in [0, 2^31)):
``tile_move``'s copy and transpose (kern_copy, kern_swap, with their
library calls) and ``l4_pack`` in each form (kern_mxu is the mma_pack
form); B on the from: model at B=32768 x L=1024 (``probe_corpus``, the
probe's recipe), pack from raw quads (B5), the scan, the post kernel in
bytes mode and the enable plane from torch ops (``en_pack=False,
qpack=False``, as the probe sets them): b0 the port's torch tail
(``decode_groups`` and the masked characters) and b3 one big byte
transpose, as torch lines; b1 B14's ``decode`` and b2 ``field_decode``
mma_pack, as kernel lines; every one held equal to b0; C qpack alone (K1,
with its enable plane).  The kernel is ``csrc/probe_emit.cu``.  Run on
the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu64

(``--device cpu`` runs the plain versions at small widths: B=4096 x L=128).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models import zoo
from ..ops import bitplane as bp
from ..ops import kernels
from ..ops.bitplane import LANE, TILE, _l4_rows
from . import harness
from .probe_tpu47 import move_line, words
from .probe_tpu48 import BF16_PEAK, MMA_FLOPS, TP, mma_count, pack_line
from .probe_tpu48 import FORMS as L4_FORMS

FORMS = ("swap", "mma_pack", "mma_select")
MAX_FIELDS = 8  # MAXF of csrc/probe_emit.cu
NBLK = 64  # section A's blocks of [1024, 128]
BIG = (32768, 1024)  # sections B and C: the from: batch (B x L)
SMALL = (4096, 128)  # the CPU's


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def fields_of(plan: bp.BitplanePlan) -> Tuple[Tuple[int, int, int], ...]:
    """A witness plan's byte-group fields as (group, first bit, bit count),
    the flags first (``plan.fields_flat`` without the names)."""
    return tuple((gi, off, nb) for _name, gi, off, nb in plan.fields_flat)


def _check_decode(g4: torch.Tensor, ch_l4: torch.Tensor, fields: Sequence, form: str
                  ) -> Tuple[int, int, int]:
    """NWS, G and L; raises on a shape, dtype, field or form it does not take."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if (g4.dtype != torch.int32 or g4.dim() != 4 or g4.shape[1] % 8 or g4.shape[3] != LANE
            or g4.numel() == 0 or g4.shape[2] % 4):
        raise ValueError(f"g4: expected [NWS, 8G, L, {LANE}] int32 with L a multiple of 4, "
                         f"got {g4.dtype}{tuple(g4.shape)}")
    NWS, G8, L, _ = g4.shape
    if ch_l4.dtype != torch.int32 or tuple(ch_l4.shape) != (NWS * TILE, L // 4):
        raise ValueError(f"ch_l4: expected int32{(NWS * TILE, L // 4)}, got "
                         f"{ch_l4.dtype}{tuple(ch_l4.shape)}")
    if not 1 <= len(fields) <= MAX_FIELDS or any(
            len(f) != 3 or not 0 <= f[0] < G8 // 8 or f[1] < 0 or f[2] < 1 or f[1] + f[2] > 8
            for f in fields):
        raise ValueError(f"fields {fields}: expected 1 to {MAX_FIELDS} (group < {G8 // 8}, "
                         "first bit, bit count) within a byte")
    return NWS, G8 // 8, L


def field_decode_plain(g4: torch.Tensor, ch_l4: torch.Tensor, fields: Sequence,
                       form: str = "mma_pack") -> torch.Tensor:
    """``decode_plain``'s function with the fields given; ``form`` does not
    change it."""
    NWS, G, L = _check_decode(g4, ch_l4, fields, form)
    g = g4.reshape(NWS, G, 8, L, LANE)
    out = []
    for gi, off, nb in fields:
        v = (g[:, gi] >> off) & _i32(((1 << nb) - 1) * 0x01010101)
        out.append(_l4_rows(v.movedim(1, 0)).reshape(ch_l4.shape))
    m = out[0] & 0x01010101  # flags, bit 0 of each byte
    m = m | (m << 1)
    m = m | (m << 2)
    out.append(ch_l4 & (m | (m << 4)))
    return torch.stack(out)


def field_decode_cuda(g4: torch.Tensor, ch_l4: torch.Tensor, fields: Sequence,
                      form: str = "mma_pack") -> torch.Tensor:
    """The ``field_decode`` kernel in ``form``: one launch (the mma forms
    read the chars 8 bytes at a time: ch_l4 must be 8-byte aligned)."""
    NWS, G, L = _check_decode(g4, ch_l4, fields, form)
    if L % TP:
        raise ValueError(f"g4 {tuple(g4.shape)}: field_decode needs L a multiple of {TP}")
    kernels._check(g4, "g4", torch.int32, tuple(g4.shape))
    kernels._check(ch_l4, "ch_l4", torch.int32, tuple(ch_l4.shape))
    kernels._check_aligned(ch_l4, "ch_l4", 8)
    flat = [int(v) for f in fields for v in f]
    out = torch.empty((len(fields) + 1, NWS * TILE, L // 4), dtype=torch.int32, device=g4.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.FIELD_DECODE, lib.h2r_field_decode, g4.data_ptr(), ch_l4.data_ptr(),
                    out.data_ptr(), (ctypes.c_int * len(flat))(*flat), len(fields), NWS, G, L,
                    L4_FORMS.index(form), kernels._stream(g4))
    return out


def field_decode(g4: torch.Tensor, ch_l4: torch.Tensor, fields: Sequence,
                 form: str = "mma_pack") -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if g4.device.type == "cpu":
        return field_decode_plain(g4, ch_l4, fields, form)
    return field_decode_cuda(g4, ch_l4, fields, form)


def decode_work(g4: torch.Tensor, n_out: int, form: str = "") -> dict:
    """The bytes a decode moves (g4 and the chars read once, ``n_out``
    [B, L] byte arrays written) and an mma form's tensor-core flops."""
    NWS, G8, L, _ = g4.shape
    BL = NWS * TILE * L
    work = dict(nbytes=g4.numel() * 4 + BL + n_out * BL, shape=[NWS * TILE, L])
    n_mma = mma_count(NWS * G8, L, form)
    if n_mma:
        work.update(mma_flops=n_mma * MMA_FLOPS, mma_peak=BF16_PEAK)
    return work


def decode_line(timer, card, probe: str, g4: torch.Tensor, ch_l4: torch.Tensor,
                fields: Sequence, form: str):
    """A ``field_decode`` measurement, and its last output."""
    return harness.measure(timer, card, probe, kernels.FIELD_DECODE,
                           lambda: field_decode(g4, ch_l4, fields, form), 1,
                           lambda: field_decode_plain(g4, ch_l4, fields, form), form=form,
                           n_fields=len(fields), **decode_work(g4, len(fields) + 1, form))


# ------------------------------------------------------------- the from: batch


@functools.lru_cache(maxsize=2)
def probe_corpus(B: int, L: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The probes' from: corpus (tools/probe_tpu64.py:201-212, the same rng
    calls): every other string a filler then a from: line, the rest
    filler; chars [B, L] uint8 and lengths [B] int32 (read-only)."""
    rng = np.random.default_rng(seed)
    chars = np.zeros((B, L), np.uint8)
    lengths = np.zeros((B,), np.int32)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz @.-:", np.uint8)
    for i in range(B):
        name = rng.choice(alpha, size=8).tobytes()
        filler = rng.choice(alpha_sp, size=int(rng.integers(0, L - 96))).tobytes()
        s = (filler + b"\r\nfrom:" + name + b"@gmail.com\r\n")[:L] if i % 2 == 0 else filler[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    chars.flags.writeable = lengths.flags.writeable = False
    return chars, lengths


@functools.lru_cache(maxsize=2)
def from_model(L: int):
    """The zoo's from: model at max_chars_size L."""
    return zoo.email_headers_model(max_chars_size=L, headers=("from",))


def batch(B: int, L: int, dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    chars, lengths = probe_corpus(B, L)
    return torch.from_numpy(chars.copy()).to(dev), torch.from_numpy(lengths.copy()).to(dev)


def chars_l4(chars: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 chars (L a multiple of 4) as l4-packed int32 [B, L/4]."""
    B, L = chars.shape
    return chars.contiguous().reshape(-1).view(torch.int32).reshape(B, L // 4)


def columns_u8(cols: torch.Tensor, L: int) -> List[torch.Tensor]:
    """l4-packed arrays [n, B, L_pad/4] -> each as a [B, L] uint8 view."""
    n, B, l4 = cols.shape
    u8 = cols.reshape(-1).view(torch.uint8).reshape(n, B, 4 * l4)
    return [u8[i, :, :L] for i in range(n)]


def torch_tail(plan: bp.BitplanePlan, g4: torch.Tensor, chars: torch.Tensor
               ) -> List[torch.Tensor]:
    """b0: the port's torch tail (``decode_groups``, each field's [B, L]
    column, then the masked characters), in ``fields_flat``'s order."""
    B, L = chars.shape
    vals = bp.decode_groups(g4, plan.wgroups, L)
    outs = [vals[name].reshape(B, L) for name, *_ in plan.fields_flat]
    return outs + [(outs[0] & 1) * chars]


def torch_tail_one_transpose(plan: bp.BitplanePlan, g4: torch.Tensor, chars: torch.Tensor
                             ) -> List[torch.Tensor]:
    """b3: one byte transpose of every group to string-major [B, L, G],
    then each field's bits."""
    B, L = chars.shape
    NWS, G8, L_pad, _ = g4.shape
    G = G8 // 8
    u8 = g4.reshape(-1).view(torch.uint8).reshape(NWS, G, 8, L_pad, LANE, 4)[:, :, :, :L]
    allb = u8.permute(2, 0, 4, 5, 3, 1).reshape(B, L, G)
    outs = [(allb[..., gi] >> off) & ((1 << nb) - 1) for _name, gi, off, nb in plan.fields_flat]
    return outs + [(outs[0] & 1) * chars]


def assert_same(probe: str, got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> None:
    """Every column bit for bit, or an AssertionError naming the first that differs."""
    if len(got) != len(want):
        raise AssertionError(f"{probe}: {len(got)} columns, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{probe}: column {i} differs from the torch tail's")


def section_a(timer, card, dev: torch.device, small: bool) -> List[dict]:
    """A: copy, swap (``tile_move``) and every ``l4_pack`` form at [NBLK,
    1024, 128] (the CPU: [4, 128, 128])."""
    x = words((4, 128, 128) if small else (NBLK, 1024, LANE), lo=0, hi=2**31, dev=dev)
    recs = [move_line(timer, card, "a_copy", x, "copy"),
            move_line(timer, card, "a_swap", x, "transpose")]
    w = x.unsqueeze(0)  # [1, NBLK, L, 128]: out [NBLK, 1, 512, L/4]
    for form in L4_FORMS:
        recs.append(pack_line(timer, card, "a_mxu" if form == "mma_pack" else f"a_l4_{form}",
                              w, form)[0])
    return recs


def section_b(timer, card, dev: torch.device, B: int, L: int) -> List[dict]:
    """B: the decode candidates on the from: batch's own g4, each held
    equal to b0."""
    model = from_model(L)
    m = bp.BitplaneMatcher(model, columns="witness", emit="bytes", en_pack=False, qpack=False,
                           device=dev)
    kplan = bp.BitplaneMatcher(model, columns="witness", emit="kdecode", device=dev).plan
    plan = m.plan
    if kplan.emit != "kdecode" or kplan.wgroups != plan.wgroups or plan.L_pad != L:
        raise AssertionError("probe_tpu64: the kdecode plan's groups differ from the bytes plan's")
    chars, lengths = batch(B, L, dev)
    len_wb = bp.len_table(lengths)
    bits, _ = bp.pack(plan, bp.raw_quads(chars, plan.L_pad), len_wb)
    logs = bp.scan(plan, bits)
    g4, _fb = bp.post(plan, logs, bp.enable_plane(len_wb, plan.L_pad))
    ch_l4 = chars_l4(chars)
    fields = fields_of(plan)
    n_out = len(fields) + 1
    work = decode_work(g4, n_out)
    recs = []
    rec, want = harness.torch_line(timer, card, "b0_xla_tail", lambda: torch_tail(plan, g4, chars),
                                   nbytes=work["nbytes"], shape=[B, L])
    recs.append(rec)
    rec, got = harness.torch_line(timer, card, "b3_xla_onetrans",
                                  lambda: torch_tail_one_transpose(plan, g4, chars),
                                  nbytes=work["nbytes"], shape=[B, L])
    assert_same("b3_xla_onetrans", got, want)
    recs.append(dict(rec, equals_b0=True))
    rec, out = harness.measure(timer, card, "b1_kdecode", kernels.DECODE,
                               lambda: bp.decode(kplan, g4, ch_l4), 1,
                               lambda: bp.decode_plain(kplan, g4, ch_l4), n_fields=len(fields),
                               **work)
    assert_same("b1_kdecode", columns_u8(out, L), want)
    recs.append(dict(rec, equals_b0=True))
    rec, out = decode_line(timer, card, "b2_mxdecode", g4, ch_l4, fields, "mma_pack")
    assert_same("b2_mxdecode", columns_u8(out, L), want)
    recs.append(dict(rec, equals_b0=True))
    return recs


def section_c(timer, card, dev: torch.device, B: int, L: int) -> List[dict]:
    """C: K1 qpack alone (with its enable plane) on the from: batch."""
    plan = bp.BitplaneMatcher(from_model(L), columns="witness", device=dev).plan
    chars, lengths = batch(B, L, dev)
    len_wb = bp.len_table(lengths)
    NWS = B // TILE  # in: the chars and lengths; out: KP bit planes and the enable plane
    nbytes = B * L + B * 4 + (plan.kp + 1) * NWS * plan.L_pad * LANE * 4
    return [harness.measure(timer, card, "c_qpack", kernels.QPACK,
                            lambda: bp.qpack(plan, chars, len_wb), 1,
                            lambda: bp.qpack_plain(plan, chars, len_wb), nbytes=nbytes,
                            shape=[B, L])[0]]


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """Sections A, B and C (each line ``harness.measure`` or a torch line);
    ``small``: A at [4, 128, 128], B and C at B=4096 x L=128 (the CPU)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    B, L = SMALL if small else BIG
    return (section_a(timer, card, dev, small) + section_b(timer, card, dev, B, L)
            + section_c(timer, card, dev, B, L))


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu64.py's probes: the transpose primitives (A), the "
                       "decode candidates on the from: batch (B: torch tails, B14, field_decode "
                       "mma_pack) and qpack alone (C) (the CPU: small widths)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
