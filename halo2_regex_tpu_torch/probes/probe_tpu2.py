"""tools/probe_tpu2.py's Pallas probes on the H100: the dispatch cost, the
DFA step time-major by a one-hot or class-factored product, the lone
chain of dependent gathers, and the one-hot compare rate.

- A ``nop(x)``: ``x + 1`` on [8, 128] int32 (wrapping), a kernel whose
  time is its launch; timed as a kernel and, as the probe did, as host µs
  a call over 50 back-to-back calls, then one synchronize, beside ``x +
  1``'s.
- C ``dfa_step(..., "onehot_mma", time_major=True)`` at TB 256, 512, 1024
  x LB 1024; D ``dfa_step(..., "class_mma", ...)`` at TB 512 (K = 16); and
  the from: batch's width (B = 32768 x L = 1024, time-major) for lookup,
  class_mma and onehot_mma.
- E ``lane_gather(g, f, 1024)``: 1024 dependent gathers on [256, 128],
  and on [1, 128] (one warp: the lone chain), the row in shared memory and
  in registers.
- F ``onehot_count(c)``: ``o[0, j] = sum_i sum_k [c[i, j] == k]`` over k
  < 256, c [1024, 512] int32 time-major: the count of each column's bytes
  in [0, 256) by 256 compares a byte; its library call is the range test
  ``((c >= 0) & (c < 256)).sum(0, dtype=torch.int32, keepdim=True)``.

``lane_gather`` and ``dfa_step`` are :mod:`.probe_tpu`'s; ``nop`` and
``onehot_count`` are ``csrc/probe_units.cu``'s.  The script's B
(``mxu_bf16_chained``: eight chained bf16 products at 2048) is timed as
torch ops, ``"kernel": null``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu2

(``--device cpu`` runs the plain versions at small widths).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu import (KC, NB, NS, bytes_, dfa_line, gather_inputs, gather_line, table)

LB = 1024  # C's and D's bytes a string
C_TB = (256, 512, 1024)  # C's strings
D_TB = 512
E_STEPS = 1024
F_SHAPE = (1024, 512)  # F's c [LB, TB]
BIG = (32768, 1024)  # the from: batch (B x L): chip_smoke's, time-major
HOST_CALLS = 50  # A: back-to-back calls a host timing


# ------------------------------------------------------------------------ nop


def _check_nop(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.numel() == 0:
        raise ValueError(f"x: expected a non-empty int32 tensor, got {x.dtype}{tuple(x.shape)}")


def nop_plain(x: torch.Tensor) -> torch.Tensor:
    """``x + 1``, int32 that wraps."""
    _check_nop(x)
    return (torch.remainder(x.to(torch.int64) + 1 + 2**31, 2**32) - 2**31).to(torch.int32)


def nop_cuda(x: torch.Tensor) -> torch.Tensor:
    """The ``nop`` kernel."""
    _check_nop(x)
    kernels._check(x, "x", torch.int32, tuple(x.shape))
    out = torch.empty_like(x)
    lib = kernels.build_probes()
    kernels._launch(kernels.NOP, lib.h2r_nop, x.data_ptr(), out.data_ptr(), x.numel(),
                    kernels._stream(x))
    return out


def nop(x: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return nop_plain(x) if x.device.type == "cpu" else nop_cuda(x)


# --------------------------------------------------------------- onehot_count


def _check_count(c: torch.Tensor) -> Tuple[int, int]:
    if c.dim() != 2 or c.shape[1] == 0 or c.dtype != torch.int32:
        raise ValueError(f"c: expected [LB, TB] int32 with TB > 0, got {c.dtype}{tuple(c.shape)}")
    return c.shape[0], c.shape[1]


def onehot_count_plain(c: torch.Tensor) -> torch.Tensor:
    """[1, TB] int32: the count of each column's values in [0, 256)."""
    _check_count(c)
    return ((c >= 0) & (c < NB)).sum(0, dtype=torch.int32).unsqueeze(0)


def onehot_count_cuda(c: torch.Tensor) -> torch.Tensor:
    """The ``onehot_count`` kernel: 256 compares a byte (on half2, two a
    compare instruction), the rows split over a cluster of blocks."""
    LB_, TB_ = _check_count(c)
    kernels._check(c, "c", torch.int32, (LB_, TB_))
    out = torch.empty((1, TB_), dtype=torch.int32, device=c.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.ONEHOT_COUNT, lib.h2r_onehot_count, c.data_ptr(), out.data_ptr(),
                    LB_, TB_, kernels._stream(c))
    return out


def onehot_count(c: torch.Tensor) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return onehot_count_plain(c) if c.device.type == "cpu" else onehot_count_cuda(c)


# ------------------------------------------------------------------------- run


def class_inputs(seed: int = 0, dev: Optional[torch.device] = None):
    """D's classes [256] in [0, 16) and Tk [16, 128] in [0, 128), seeded."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, KC, size=NB).astype(np.int32)
    tk = rng.integers(0, NS, size=(KC, NS)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (classes, tk))


def run(dev: torch.device, small: bool = False, big: bool = False) -> List[dict]:
    """A (``nop``, with host µs a call), B (torch), C and D (``dfa_step``
    time-major), with ``big`` the from: batch's width (lookup, class_mma,
    onehot_mma), E (``lane_gather``'s 1024-step chain on [256, 128] and
    [1, 128], both storage forms) and F (``onehot_count``): a line each
    (``harness.measure``).  ``small``: TB 16, LB 32, 16 steps and small
    products (the CPU run)."""
    c_tb, lb, d_tb = ((16,), 32, 16) if small else (C_TB, LB, D_TB)
    e_rows, e_steps = ((4, 1), 16) if small else ((256, 1), E_STEPS)
    f_shape, mm = ((32, 16), 64) if small else (F_SHAPE, 2048)
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    rec, _ = harness.measure(timer, card, "A_dispatch_nop", kernels.NOP, lambda: nop(x), 1,
                             lambda: nop_plain(x), library=lambda: x + 1,
                             nbytes=2 * x.numel() * 4, int32_ops=x.numel(), shape=[8, 128])
    rec.update(host_us_a_call=harness.host_us(dev, lambda: nop(x), HOST_CALLS),
               torch_host_us_a_call=harness.host_us(dev, lambda: x + 1, HOST_CALLS),
               host_calls=HOST_CALLS)
    recs.append(rec)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((mm, mm)).astype(np.float32)).to(dev, torch.bfloat16)

    def mm8():
        y = a
        for _ in range(8):
            y = torch.matmul(y, a)
        return y

    rec, _ = harness.torch_line(timer, card, "mxu_bf16_chained", mm8, shape=[mm, mm],
                                flops=8 * 2 * mm**3)
    recs.append(rec)
    T = table().to(dev)
    for tb in c_tb:
        c = bytes_(lb, tb, seed=tb, dev=dev)
        recs.append(dfa_line(timer, card, f"C_onehot_mxu_tm_{tb}x{lb}", T, c, "onehot_mma",
                             True))
    classes, tk = class_inputs(dev=dev)
    c = bytes_(lb, d_tb, seed=d_tb + 1, dev=dev)
    recs.append(dfa_line(timer, card, "D_class_factor_mxu", tk, c, "class_mma", True,
                         classes=classes))
    if big:
        cb = bytes_(BIG[1], BIG[0], seed=7, dev=dev)
        for form in ("lookup", "class_mma", "onehot_mma"):
            t_ = tk if form == "class_mma" else T
            recs.append(dfa_line(timer, card, f"dfa_{form}_tm_{BIG[0]}x{BIG[1]}", t_, cb, form,
                                 True, classes=classes if form == "class_mma" else None))
    for R in e_rows:
        g, f = gather_inputs(R, seed=R + 3, dev=dev)
        for store in ("shared", "regs"):
            recs += gather_line(timer, card, f"E_take_along_loop_{R}x128", g, f, e_steps, store)
    cf = bytes_(*f_shape, seed=5, dev=dev)
    recs.append(harness.measure(
        timer, card, "F_vpu_onehot_count", kernels.ONEHOT_COUNT, lambda: onehot_count(cf),
        f_shape[0], lambda: onehot_count_plain(cf),
        library=lambda: ((cf >= 0) & (cf < NB)).sum(0, dtype=torch.int32, keepdim=True),
        nbytes=(cf.numel() + f_shape[1]) * 4,
        half2_ops=NB * cf.numel(), shape=list(f_shape))[0])  # HSET2 + HADD2 a key pair
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu2.py's probes: nop, dfa_step (C, D), lane_gather's "
                       "chain (E), onehot_count (F) at the probe's widths (the CPU: small "
                       "ones)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu", big=dev.type == "cuda")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
