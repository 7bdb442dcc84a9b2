"""tools/probe_tpu6.py's bisects on the H100: a carried running sum, the
one-hot DFA step, a packed table's second column, a byte's class as a
chain of compares.

- k1 (:39): the running sum down L, carried across 2 chunks of 64:
  :mod:`.probe_tpu9`'s ``loop_floor`` (slab 1) at x [128, 256] in [0, 5),
  ``torch.cumsum`` beside it.
- k2 (:72): ``s = T[c, s]`` from 0 by a one-hot bf16 product and a select
  sum, carried across 2 chunks: :mod:`.probe_tpu28`'s ``dfa_wide`` (lookup
  and onehot_mma) with T [256, 32] in [0, 32), bytes [128, 128].
- k3 (:126): the state ``s = P4[c, s]`` and the output ``P4[c, S +
  s_prev]``, static slices of a packed [256, 4S] table: the slab kernel of
  :mod:`.probe_tpu18` (``slab_anatomy``, two outputs, from state 0) with
  the identity as its class map, its second output.  Its table and map
  take 132 KiB of shared memory, past the 48 KiB default: the slab
  launch opts in (``csrc/probe_slab.cuh``).
- k4 (:174): ``class_chain(c, terms, form)``: cls = sum of delta x (c >=
  b) over the terms (b, delta), int32 elementwise; ``form`` ``"chain"``
  (the compares unrolled, the terms a launch argument) or ``"table"`` (the
  chain evaluated for the 256 bytes into shared memory, then one lookup
  at the byte clamped to [0, 255]: the same function for every c while
  each b lies in [1, 255], as the probe's draws do; the wrapper refuses
  other thresholds).  ``((c[..., None] >= b) * delta).sum(-1)`` is its
  library call.  The probe's 30 draws keep the terms with delta != 0.

The kernels: ``csrc/probe_tpu9.cu`` (loop_floor), ``probe_dfa_wide.cu``,
``probe_tpu18.cu`` (slab_anatomy) and ``probe_units.cu`` (class_chain).
Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu6

(``--device cpu`` runs the plain versions at the probe's widths).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu9 import loop_floor, loop_floor_plain
from .probe_tpu18 import slab_anatomy, slab_anatomy_plain
from .probe_tpu28 import as_table, dfa_wide_plain, plain_once, wide_line

TB, LC, NL, S = 128, 64, 2, 32  # the probe's strings, chunk, chunks, k2's and k3's states
L = LC * NL
NB = 256  # bytes
CHAIN_FORMS = ("chain", "table")
MAX_TERMS = 32  # MAX_TERMS of csrc/probe_units.cu
BIG = (1024, 32768)  # k4 at the from: batch, time-major [L, B]


# ---------------------------------------------------------------- class_chain


def _check_chain(c: torch.Tensor, terms: Sequence[Tuple[int, int]], form: str) -> None:
    if form not in CHAIN_FORMS:
        raise ValueError(f"form {form!r}: expected one of {CHAIN_FORMS}")
    if c.dtype != torch.int32 or c.numel() == 0:
        raise ValueError(f"c: expected a non-empty int32 tensor, got {c.dtype}{tuple(c.shape)}")
    if len(terms) > MAX_TERMS or any(not -2**31 <= int(v) < 2**31 for t in terms for v in t):
        raise ValueError(f"terms: at most {MAX_TERMS} (b, delta) pairs of int32")
    if form == "table" and any(not 1 <= int(b) <= 255 for b, _d in terms):
        raise ValueError("the table form needs every threshold b in [1, 255] (a byte clamped "
                         "to [0, 255] then has the class of any c)")


def _chain(c: torch.Tensor, terms: Sequence[Tuple[int, int]]) -> torch.Tensor:
    cls = torch.zeros_like(c)
    for b, d in terms:
        cls = cls + int(d) * (c >= int(b)).to(torch.int32)
    return cls


def class_chain_plain(c: torch.Tensor, terms: Sequence[Tuple[int, int]],
                      form: str = "chain") -> torch.Tensor:
    """Each form step by step: ``"chain"`` the probe's chain, term by term,
    cls = cls + delta * (c >= b) in int32 (wrapping); ``"table"`` the chain
    of the bytes 0..255, then a lookup at c clamped to [0, 255] (the same
    classes, where the thresholds lie in [1, 255])."""
    _check_chain(c, terms, form)
    if form == "chain":
        return _chain(c, terms)
    tab = _chain(torch.arange(NB, dtype=torch.int32, device=c.device), terms)
    return tab[c.clamp(0, NB - 1).long()]


def class_chain_cuda(c: torch.Tensor, terms: Sequence[Tuple[int, int]],
                     form: str = "chain") -> torch.Tensor:
    """The ``class_chain`` kernel in ``form``: four elements a thread (c
    16-byte aligned)."""
    _check_chain(c, terms, form)
    kernels._check(c, "c", torch.int32, tuple(c.shape))
    kernels._check_aligned(c, "c", 16)
    out = torch.empty_like(c)
    bs = (ctypes.c_int * max(len(terms), 1))(*[int(b) for b, _d in terms])
    ds = (ctypes.c_int * max(len(terms), 1))(*[int(d) for _b, d in terms])
    lib = kernels.build_probes()
    kernels._launch(kernels.CLASS_CHAIN, lib.h2r_class_chain, c.data_ptr(), out.data_ptr(),
                    c.numel(), bs, ds, len(terms), CHAIN_FORMS.index(form), kernels._stream(c))
    return out


def class_chain(c: torch.Tensor, terms: Sequence[Tuple[int, int]],
                form: str = "chain") -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    return class_chain_plain(c, terms, form) if c.device.type == "cpu" else \
        class_chain_cuda(c, terms, form)


def chain_library(c: torch.Tensor, terms: Sequence[Tuple[int, int]]):
    """One PyTorch call of the same function, its thresholds and deltas as
    tensors on c's device (made here once): a call that gives it."""
    b = torch.tensor([int(t[0]) for t in terms], dtype=torch.int32, device=c.device)
    d = torch.tensor([int(t[1]) for t in terms], dtype=torch.int32, device=c.device)
    return lambda: ((c[..., None] >= b) * d).sum(-1, dtype=torch.int32)


# ------------------------------------------------------------------------- run


def inputs(seed: int = 0, dev: Optional[torch.device] = None) -> dict:
    """The probe's arrays, drawn in its order from one generator: k1's x
    [L, 2 TB] in [0, 5), T [256, S], k2's x [L, TB] bytes, P4 [256, 4S],
    k3's x, then k4's terms and x [LC, TB] bytes."""
    rng = np.random.default_rng(seed)
    out = {"x1": rng.integers(0, 5, size=(L, 2 * TB)), "T": rng.integers(0, S, size=(256, S)),
           "x2": rng.integers(0, 256, size=(L, TB)), "P4": rng.integers(0, S, size=(256, 4 * S)),
           "x3": rng.integers(0, 256, size=(L, TB))}
    bs, ds = rng.integers(1, 256, 30), rng.integers(-3, 4, 30)
    out["x4"] = rng.integers(0, 256, size=(LC, TB))
    t = {k: torch.from_numpy(v.astype(np.int32)).to(dev or "cpu") for k, v in out.items()}
    t["terms"] = [(int(b), int(d)) for b, d in zip(bs, ds) if d != 0]
    return t


def chain_line(timer, card, probe: str, c: torch.Tensor, terms, form: str) -> dict:
    """A ``class_chain`` measurement with its library call; a step is one
    element.  Its operations: a compare and an add a term an element
    (chain), or those for the 256 bytes and a lookup an element (table)."""
    return harness.measure(
        timer, card, probe, kernels.CLASS_CHAIN, lambda: class_chain(c, terms, form), c.numel(),
        lambda: class_chain_plain(c, terms, form),
        library=chain_library(c, terms) if c.is_cuda else None, nbytes=2 * c.numel() * 4,
        int32_ops=(2 * len(terms) * c.numel() if form == "chain"
                   else c.numel() + 2 * len(terms) * NB),
        shape=list(c.shape), form=form, terms=len(terms))[0]


def run(dev: torch.device, big: bool = True) -> List[dict]:
    """k1-k4 at the probe's widths (k4 in both forms, and with ``big`` at
    the from: batch's [1024, 32768] too): a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    t = inputs(dev=dev)
    x1 = t["x1"]
    recs = [harness.measure(
        timer, card, "k1_grid_scratch", kernels.LOOP_FLOOR, lambda: loop_floor(x1, 1), L,
        lambda: loop_floor_plain(x1, 1), library=lambda: torch.cumsum(x1, 0, dtype=torch.int32),
        nbytes=2 * x1.numel() * 4, int32_ops=x1.numel(), shape=list(x1.shape), slab=1)[0]]
    T = as_table(t["T"])
    want = plain_once(timer, lambda: dfa_wide_plain(T, t["x2"]))
    for form in ("lookup", "onehot_mma"):
        recs.append(wide_line(timer, card, "k2_onehot_sel_grid", T, t["x2"], form, want)[0])
    ident = torch.arange(NB, dtype=torch.int32, device=dev)
    P4, x3 = t["P4"], t["x3"]
    recs.append(harness.measure(
        timer, card, "k3_packed_slices", kernels.SLAB_ANATOMY,
        lambda: slab_anatomy(P4, ident, x3, 0, 2)[1], L,
        lambda: slab_anatomy_plain(P4, ident, x3, 0, 2)[1],
        nbytes=(2 * x3.numel() + P4.numel() + NB) * 4, int32_ops=2 * x3.numel(),
        shape=list(x3.shape), S=S, n_out=2)[0])
    shapes = [("k4_boundary_chain", t["x4"])]
    if big:
        rng = np.random.default_rng(4)
        shapes.append(("k4_boundary_chain", torch.from_numpy(
            rng.integers(0, 256, size=BIG).astype(np.int32)).to(dev)))
    for probe, c in shapes:
        for form in CHAIN_FORMS:
            recs.append(chain_line(timer, card, probe, c, t["terms"], form))
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu6.py's k1-k4: loop_floor, dfa_wide, slab_anatomy with "
                       "the identity class map and class_chain at the probe's widths (k4 also "
                       f"at {list(BIG)} on the card)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, big=dev.type == "cuda")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
