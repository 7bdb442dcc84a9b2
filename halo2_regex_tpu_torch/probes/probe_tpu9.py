"""tools/probe_tpu9.py's A, B and C on the H100: what a serial loop's step
costs with its rows in shared memory, and what the probe's table step
costs.

- ``loop_floor(x, slab)``: ``o[i] = x[i] + o[i - 1]`` down the rows of x
  [L, TB] int32, int32 sums that wrap (JAX's adds); slab 1 is the probe's
  A (``ka``), slab 8 its B (``kb``: eight rows a loop step).
- ``slab_scan(tk, classes, x)``: the probe's C (``kc``): per step the
  class of byte x[i, b], then ``v_j = tk[class, j * S + s]`` for j = 0..3
  and ``s = v_0`` from s = 0; four [L, TB] int32 outputs.

The kernels are ``csrc/probe_tpu9.cu`` (``loop_floor``, ``slab_scan``).
Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu9

(``--device cpu`` runs the plain versions at L=64, TB=32).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness

L, TB = 1024, 256  # the probe's shape
K, S = 16, 32  # probe C's classes and states
SLAB = 8  # probe C's rows a loop step (and B's)


def _check_floor(x: torch.Tensor, slab: int) -> Tuple[int, int]:
    if x.dim() != 2 or x.dtype != torch.int32:
        raise ValueError(f"x: expected a [L, TB] int32 tensor, got {x.dtype}{tuple(x.shape)}")
    if slab not in (1, SLAB) or x.shape[0] % slab:
        raise ValueError(f"slab {slab}: expected 1 or {SLAB}, dividing L = {x.shape[0]}")
    return x.shape[0], x.shape[1]


def loop_floor_plain(x: torch.Tensor, slab: int = 1) -> torch.Tensor:
    """The running sum down dim 0 in int32 that wraps as JAX's adds do
    (summed in int64, then cut to 32 bits); ``slab`` does not change it."""
    _check_floor(x, slab)
    wide = torch.cumsum(x.to(torch.int64), 0)
    return (torch.remainder(wide + 2**31, 2**32) - 2**31).to(torch.int32)


def loop_floor_cuda(x: torch.Tensor, slab: int = 1) -> torch.Tensor:
    """The ``loop_floor`` kernel, ``slab`` rows a loop step (1 or 8)."""
    L_, TB_ = _check_floor(x, slab)
    kernels._check(x, "x", torch.int32, (L_, TB_))
    out = torch.empty_like(x)
    lib = kernels.build_probes()
    kernels._launch(kernels.LOOP_FLOOR, lib.h2r_loop_floor, x.data_ptr(), out.data_ptr(), slab,
                    L_, TB_, kernels._stream(x))
    return out


def loop_floor(x: torch.Tensor, slab: int = 1) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return loop_floor_plain(x, slab) if x.device.type == "cpu" else loop_floor_cuda(x, slab)


def check_table(tk: torch.Tensor, classes: torch.Tensor) -> Tuple[int, int]:
    """The table's shapes and dtypes.  Returns (K, S)."""
    if tk.dim() != 2 or tk.shape[1] % 4 or tk.shape[1] == 0 or tk.dtype != torch.int32:
        raise ValueError(f"tk: expected a [K, 4S] int32 tensor, got {tk.dtype}{tuple(tk.shape)}")
    if tuple(classes.shape) != (256,) or classes.dtype != torch.int32:
        raise ValueError(f"classes: expected [256] int32, got "
                         f"{classes.dtype}{tuple(classes.shape)}")
    return tk.shape[0], tk.shape[1] // 4


def check_ranges(tk: torch.Tensor, classes: torch.Tensor) -> Tuple[int, int]:
    """The value ranges of the probe's bf16 path, the precondition of
    ``slab_scan``: tk [K, 4S] in [0, S) (a one-hot bf16 product and a
    select carry them exactly, and a state never leaves the table) and
    classes [256] in [0, K).  On the card it waits for the device, so the
    plain version checks it and the kernel's wrapper leaves it to its
    caller.  Returns (K, S)."""
    k, s = check_table(tk, classes)
    if bool(((tk < 0) | (tk >= s)).any()):
        raise ValueError(f"tk: values must lie in [0, S = {s}), as the probe's table does")
    if bool(((classes < 0) | (classes >= k)).any()):
        raise ValueError(f"classes: values must lie in [0, K = {k})")
    return k, s


def _check_x(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() != 2 or x.dtype != torch.int32 or x.shape[0] == 0 or x.shape[0] % SLAB:
        raise ValueError(f"x: expected [L, TB] int32 with L a positive multiple of {SLAB}, got "
                         f"{x.dtype}{tuple(x.shape)}")
    return x.shape[0], x.shape[1]


def slab_plain(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int = 0,
               n_out: int = 4):
    """The slab kernel's scan (``csrc/probe_slab.cuh``) step by step: one
    gather of the state column a position along L, from state ``first``,
    then the first ``n_out`` columns at every position at once.  A byte
    outside [0, 256) takes the class of 0 or 255, as the probes' thresholds
    give it.  The state column must keep a state in [0, S), as the
    callers' checks make sure."""
    _k, s_ = check_table(tk, classes)
    L_, TB_ = _check_x(x)
    flat = tk.reshape(-1).to(torch.int64)
    base = classes[x.clamp(0, 255).long()].to(torch.int64) * (4 * s_)  # [L, TB]
    s = torch.full((TB_,), first, dtype=torch.int64, device=x.device)
    states = [s]  # the state before each step
    for i in range(L_ - 1):
        s = flat[base[i] + s]
        states.append(s)
    prev = torch.stack(states)
    return tuple(flat[base + j * s_ + prev].to(torch.int32) for j in range(n_out))


def slab_scan_plain(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor):
    """The probe's C (``slab_plain`` from state 0, four outputs).  It
    checks the tables' ranges (``check_ranges``)."""
    check_ranges(tk, classes)
    return slab_plain(tk, classes, x)


def slab_scan_cuda(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor):
    """The ``slab_scan`` kernel: the same four outputs as
    ``slab_scan_plain``.  Precondition (``check_ranges``; not checked here,
    since that waits for the device): tk's values lie in [0, S) and
    classes' in [0, K); outside them the kernel reads past its table."""
    k, s = check_table(tk, classes)
    L_, TB_ = _check_x(x)
    kernels._check(tk, "tk", torch.int32, (k, 4 * s))
    kernels._check(classes, "classes", torch.int32, (256,))
    kernels._check(x, "x", torch.int32, (L_, TB_))
    outs = tuple(torch.empty_like(x) for _ in range(4))
    lib = kernels.build_probes()
    kernels._launch(kernels.SLAB_SCAN, lib.h2r_slab_scan, tk.data_ptr(), classes.data_ptr(),
                    x.data_ptr(), *(o.data_ptr() for o in outs), L_, TB_, k, s,
                    kernels._stream(x))
    return outs


def slab_scan(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor):
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return slab_scan_plain(tk, classes, x)
    return slab_scan_cuda(tk, classes, x)


def inputs(L_: int, TB_: int, seed: int = 0, dev: Optional[torch.device] = None):
    """The probe's inputs, seeded: bytes x [L, TB] in [0, 256), a class
    map [256] in [0, K) and a table tk [K, 4S] in [0, S), all int32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(L_, TB_)).astype(np.int32)
    classes = rng.integers(0, K, size=256).astype(np.int32)
    tk = rng.integers(0, S, size=(K, 4 * S)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (x, classes, tk))


def run(dev: torch.device, widths: Sequence[Tuple[int, int]] = ((L, TB),),
        scan_widths: Optional[Sequence[Tuple[int, int]]] = None) -> List[dict]:
    """A and B (``loop_floor``, slab 1 and 8) at each [L, TB] of ``widths``,
    with ``torch.cumsum`` beside them, and C (``slab_scan``) at those of
    ``scan_widths`` (default: all): a line each (``harness.measure``)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    scan_widths = widths if scan_widths is None else scan_widths
    recs = []
    for L_, TB_ in widths:
        x, classes, tk = inputs(L_, TB_, dev=dev)
        work = dict(nbytes=2 * x.numel() * 4, int32_ops=x.numel(), shape=[L_, TB_])
        for probe, slab in (("A_loop_floor", 1), ("B_slab8_floor", SLAB)):
            recs.append(harness.measure(
                timer, card, probe, kernels.LOOP_FLOOR, lambda: loop_floor(x, slab), L_,
                lambda: loop_floor_plain(x, slab),
                library=lambda: torch.cumsum(x, 0, dtype=torch.int32), slab=slab, **work)[0])
        if (L_, TB_) in scan_widths:
            recs.append(harness.measure(
                timer, card, "C_slab8_scan", kernels.SLAB_SCAN,
                lambda: slab_scan(tk, classes, x), L_, lambda: slab_scan_plain(tk, classes, x),
                nbytes=(5 * x.numel() + tk.numel() + classes.numel()) * 4,
                int32_ops=5 * x.numel(), shape=[L_, TB_], K=K, S=S)[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu9.py's A, B and C: loop_floor and slab_scan at "
                       f"[{L}, {TB}] (the CPU: [64, 32])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, ((64, 32),) if dev.type == "cpu" else ((L, TB),))
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
