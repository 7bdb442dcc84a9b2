"""tools/probe_tpu48.py's Pallas probes on the H100: the direct [B, L]
witness emission from the packed domain against "copy, then decode with
the library's ops".

- ``l4_pack(words, form)``: byte-lane words [A, M, L, 128] int32 -> the
  string-major l4-packed rows [M, A, 512, L/4] int32, ``out[m, a]`` the
  rows of ``words[a, m]``: row 4 * lane + s holds byte lane s of lane
  ``lane``'s words, position l in byte l % 4 of column l / 4 (the port's
  ``ops.bitplane._l4_rows``).  At A = NWS, M = 8 the output's bytes are
  the [B, L] uint8 column of the probe's ``direct_full``, a view.
  ``form``: ``"permute"`` (B14's design: 4 x 4 byte blocks by byte
  permutes and a shared tile of rows), ``"swap"`` (an int32 tile transpose
  through shared memory, then a four-column pack by shifts and masks),
  ``"mma_pack"`` (the tensor cores, ``mma.sync`` bf16 x bf16 -> f32 with
  probe_tpu64's packing matrix) or ``"mma_select"`` (with probe_tpu68's
  selector).  Every form gives the same words.  L is a multiple of 64 on
  the card.

The probe's A (kern_direct) is ``l4_pack`` in its permute form at W [NWS=8,
M=8, L=1024, LANE=128], with the library's strided copy of the same rows
(``l4_pack_library``) timed beside it; its kern_id is ``tile_move``'s
copy (:mod:`.probe_tpu47`), and its status quo (kern_id, then the bitcast
and transpose to [B, L]) is timed as torch ops beside it, ``"kernel":
null``.
The direct column must equal the status quo's, as the probe asserts.  The
kernel is ``csrc/probe_emit.cu``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu48

(``--device cpu`` runs the plain versions at a small width).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..ops import kernels
from ..ops.bitplane import LANE, _l4_rows
from . import harness
from .probe_tpu47 import SHAPE, SMALL, tile_move, tile_move_plain, words

FORMS = ("permute", "swap", "mma_pack", "mma_select")
TP = 64  # positions a block of csrc/probe_emit.cu: L is a multiple of it on the card
MMA_FLOPS = 2 * 16 * 8 * 16  # one mma.sync.m16n8k16
BF16_PEAK = 989e12  # the H100 SXM's dense bf16 tensor-core rate (data sheet)


def _check_pack(w: torch.Tensor, form: str) -> Tuple[int, int, int]:
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if w.dtype != torch.int32 or w.dim() != 4 or w.shape[3] != LANE or w.numel() == 0 \
            or w.shape[2] % 4:
        raise ValueError(f"words: expected [A, M, L, {LANE}] int32 with L a multiple of 4, "
                         f"got {w.dtype}{tuple(w.shape)}")
    return w.shape[0], w.shape[1], w.shape[2]


def l4_pack_plain(w: torch.Tensor, form: str = "permute") -> torch.Tensor:
    """``_l4_rows`` of each plane, the two leading dims swapped; ``form``
    does not change it."""
    _check_pack(w, form)
    return _l4_rows(w).transpose(0, 1).contiguous()


def l4_pack_library(w: torch.Tensor) -> torch.Tensor:
    """The same rows by one strided copy of the library (``contiguous`` of
    the words' bytes permuted to [M, A, lane, s, l]), viewed as int32:
    the library call timed beside ``l4_pack``, never the port."""
    A, M, L = _check_pack(w, "permute")
    u8 = w.view(torch.uint8).reshape(A, M, L, LANE, 4).permute(1, 0, 3, 4, 2).contiguous()
    return u8.view(torch.int32).reshape(M, A, 4 * LANE, L // 4)


def l4_pack_cuda(w: torch.Tensor, form: str = "permute") -> torch.Tensor:
    """The ``l4_pack`` kernel in ``form``."""
    A, M, L = _check_pack(w, form)
    if L % TP:
        raise ValueError(f"words {tuple(w.shape)}: l4_pack needs L a multiple of {TP}")
    kernels._check(w, "words", torch.int32, tuple(w.shape))
    out = torch.empty((M, A, 4 * LANE, L // 4), dtype=torch.int32, device=w.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.L4_PACK, lib.h2r_l4_pack, w.data_ptr(), out.data_ptr(), A, M, L,
                    FORMS.index(form), kernels._stream(w))
    return out


def l4_pack(w: torch.Tensor, form: str = "permute") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return l4_pack_plain(w, form) if w.device.type == "cpu" else l4_pack_cuda(w, form)


def mma_count(planes: int, L: int, form: str) -> int:
    """The ``mma.sync`` an mma form issues over ``planes`` planes of L
    positions: per 16 lanes, 32 positions and byte lane, 8 (selector) or 4
    (packing matrix); none for the other forms."""
    per = {"mma_select": 8, "mma_pack": 4}.get(form, 0)
    return planes * (LANE // 16) * (L // 32) * 4 * per


def pack_line(timer, card, probe: str, w: torch.Tensor, form: str):
    """An ``l4_pack`` measurement (the words in, the rows out; an mma form
    also carries its tensor-core flops and peak) with its library call
    (``l4_pack_library``), and its last output."""
    A, M, L = _check_pack(w, form)
    extra = {}
    n_mma = mma_count(A * M, L, form)
    if n_mma:
        extra = dict(mma_flops=n_mma * MMA_FLOPS, mma_peak=BF16_PEAK)
    return harness.measure(timer, card, probe, kernels.L4_PACK, lambda: l4_pack(w, form), A * M,
                           lambda: l4_pack_plain(w, form), library=lambda: l4_pack_library(w),
                           nbytes=2 * w.numel() * 4,
                           shape=list(w.shape), form=form, **extra)


def status_quo(w: torch.Tensor) -> torch.Tensor:
    """The probe's status quo: the word planes copied by a kernel
    (``tile_move``), then bitcast to bytes and transposed to [B, L]."""
    NWS, M, L, _ = w.shape
    g = tile_move(w, "copy")
    u8 = g.reshape(-1).view(torch.uint8).reshape(NWS, M, L, LANE, 4)
    return u8.permute(1, 0, 3, 4, 2).reshape(NWS * M * LANE * 4, L)


def direct_full(out: torch.Tensor) -> torch.Tensor:
    """``l4_pack``'s rows [M, NWS, 512, L/4] as the [B, L] uint8 column: a
    view, string order (m, nws, lane, s)."""
    M, NWS, R, l4 = out.shape
    return out.reshape(-1).view(torch.uint8).reshape(M * NWS * R, 4 * l4)


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """A (``l4_pack`` permute, the probe's direct emission) and kern_id
    (``tile_move`` copy) at W [8, 8, 1024, 128] (the CPU: [2, 2, 128,
    128]), each a ``harness.measure`` line, and the status quo as a torch
    line; the direct column is held equal to the status quo's."""
    timer, card = harness.Timer(dev), harness.card(dev)
    w = words(SMALL if small else SHAPE, dev=dev)
    recs = []
    rec, out = pack_line(timer, card, "A_direct", w, "permute")
    direct = direct_full(out)
    recs.append(rec)
    nbytes = 2 * w.numel() * 4
    rec = harness.measure(timer, card, "kern_id", kernels.TILE_MOVE, lambda: tile_move(w, "copy"),
                          w.shape[0], lambda: tile_move_plain(w, "copy"),
                          library=lambda: w.clone(), nbytes=nbytes, shape=list(w.shape),
                          form="copy")[0]
    recs.append(rec)
    rec, want = harness.torch_line(timer, card, "B_status_quo", lambda: status_quo(w),
                                   shape=list(w.shape), nbytes=2 * nbytes)
    if not torch.equal(direct, want):
        raise AssertionError("probe_tpu48: the direct [B, L] emission differs from the status "
                             "quo's decode")
    rec["direct_equals_status_quo"] = True
    recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu48.py's probes: the direct emission (l4_pack permute), "
                       "the plane copy (tile_move) and the status quo at [8, 8, 1024, 128] (the "
                       "CPU: a small width)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
