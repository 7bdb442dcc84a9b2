"""tools/probe_tpu47.py's Pallas probes on the H100: an int32 tile
transpose against a tile copy of one witness-column-sized array.

- ``tile_move(x, "transpose")``: x [..., R, C] int32 -> [..., C, R] (the
  probe's kern_t, ``swapaxes(x, 2, 3)`` by (LC=256, LANE) tiles); and
  ``tile_move(x, "copy")``: the same staging, y = x (kern_c).  R and C are
  multiples of 4 on the card.

Both at X [NWS=8, M=8, L=1024, LANE=128] int32 (33.5 MB, one packed
witness column), full-range values from a seed; the probe's XLA
transpose is the transpose's library call
(``x.transpose(-2, -1).contiguous()``), ``x.clone()`` the copy's.  The
kernel is ``csrc/probe_tile_move.cu``; probe_tpu48's kern_id and
probe_tpu64's kern_copy and kern_swap are the same kernel.  Run on the
card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu47

(``--device cpu`` runs the plain versions at a small width).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness

SHAPE = (8, 8, 1024, 128)  # NWS, M, L, LANE: one packed witness column
SMALL = (2, 2, 128, 128)
FORMS = ("copy", "transpose")


def _check_move(x: torch.Tensor, form: str) -> Tuple[int, int, int]:
    """[N, R, C] of x's leading dims, rows and columns."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if x.dtype != torch.int32 or x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"x: expected a non-empty [..., R, C] int32 tensor, got "
                         f"{x.dtype}{tuple(x.shape)}")
    R, C = x.shape[-2:]
    return x.numel() // (R * C), R, C


def tile_move_plain(x: torch.Tensor, form: str = "transpose") -> torch.Tensor:
    """``x.clone()`` (copy) or ``x.transpose(-2, -1).contiguous()``."""
    _check_move(x, form)
    return x.clone() if form == "copy" else x.transpose(-2, -1).contiguous()


def tile_move_cuda(x: torch.Tensor, form: str = "transpose") -> torch.Tensor:
    """The ``tile_move`` kernel: 64 x 64-word tiles through shared memory,
    16-byte loads (x must be 16-byte aligned)."""
    N, R, C = _check_move(x, form)
    if R % 4 or C % 4 or N > 65535:
        raise ValueError(f"x {tuple(x.shape)}: tile_move needs R and C multiples of 4 and "
                         f"at most 65535 matrices")
    kernels._check(x, "x", torch.int32, tuple(x.shape))
    kernels._check_aligned(x, "x", 16)
    shape = x.shape if form == "copy" else (*x.shape[:-2], C, R)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.TILE_MOVE, lib.h2r_tile_move, x.data_ptr(), out.data_ptr(), N, R, C,
                    FORMS.index(form), kernels._stream(x))
    return out


def tile_move(x: torch.Tensor, form: str = "transpose") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return tile_move_plain(x, form) if x.device.type == "cpu" else tile_move_cuda(x, form)


def words(shape, seed: int = 0, lo: int = -(2**31), hi: int = 2**31 - 1,
          dev: Optional[torch.device] = None) -> torch.Tensor:
    """Seeded int32 words in [lo, hi), the probes' full range by default."""
    rng = np.random.default_rng(seed)
    a = rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(a).to(dev or "cpu")


def move_line(timer, card, probe: str, x: torch.Tensor, form: str) -> dict:
    """A ``tile_move`` measurement with its library call; a step is one
    matrix, and the line carries its read + write rate."""
    N, R, C = _check_move(x, form)
    lib = (lambda: x.clone()) if form == "copy" else (lambda: x.transpose(-2, -1).contiguous())
    nbytes = 2 * x.numel() * 4
    rec = harness.measure(timer, card, probe, kernels.TILE_MOVE, lambda: tile_move(x, form), N,
                          lambda: tile_move_plain(x, form), library=lib, nbytes=nbytes,
                          shape=list(x.shape), form=form)[0]
    if "ms" in rec:
        rec["gbytes_per_sec"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    return rec


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """The tile transpose and the tile copy at X [8, 8, 1024, 128] (the
    CPU: [2, 2, 128, 128]): a line each (``harness.measure``)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    x = words(SMALL if small else SHAPE, dev=dev)
    return [move_line(timer, card, "pallas_tile_T", x, "transpose"),
            move_line(timer, card, "pallas_copy", x, "copy")]


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu47.py's probes: the int32 tile transpose and copy "
                       "(tile_move) at [8, 8, 1024, 128] (the CPU: a small width)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
