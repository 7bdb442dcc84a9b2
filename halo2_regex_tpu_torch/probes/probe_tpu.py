"""tools/probe_tpu.py's Pallas probes on the H100: lane gathers, a row
gather by byte, and the DFA step by a one-hot product or a lookup.

- ``lane_gather(g, f, steps=1, store="shared", form=None)``: ``o[r, j] =
  g[r, f[r, j]]`` over rows of 128 int32 lanes, ``steps`` times with f
  taken from the last output (k3 at [8, 128], k4 at [256, 128];
  probe_tpu2's E and probe_tpu3's loop at 1024 steps).  ``store`` is the
  row's storage on the card: ``"shared"`` (one shared-memory load an
  output) or ``"regs"`` (registers, gathered by warp shuffles, the TPU's
  lane permute).  ``form`` (``GATHER_FORMS``): ``"serial"``, the chain of
  ``steps`` dependent gathers, or ``"pow"``, the default past one step:
  each row g is then a map of [0, 128) into itself and the output is
  g^steps(f), built by squaring (``pow_rounds``: 1024 steps are 10
  squarings and one gather); ``lane_gather_pow_plain`` is its torch twin.
- ``row_gather(t, c)``: ``o[i, :] = t[c[i], :]`` (k5).
- ``dfa_step(T, chars, form, time_major, pick, classes)``: the DFA scan
  ``s = T[c, s]`` from s = 0, every state written, T [256, 128] in [0,
  128), bytes in [0, 256), batch-major [TB, LB] or time-major [LB, TB].
  ``form``: ``"lookup"`` (k7: T in shared memory), ``"onehot_mma"`` (k6,
  probe_tpu2's C, probe_tpu3's fullwidth and select: the one-hot of the
  bytes, built in registers, times the whole T on the tensor cores,
  ``wgmma`` with A from registers), or
  ``"class_mma"`` (probe_tpu2's D: one-hot @ C [256, 16] @ Tk [16, 128],
  T = Tk[classes]; ``T`` is then Tk [K, 128], K <= 16).  ``pick``: how the
  products pick column s, ``"gather"`` (through shared memory, the
  probes' take_along_axis) or ``"sum"`` (a masked sum, probe_tpu3's
  select).  Every form gives the lookup loop's states bit for bit.

The kernels are ``csrc/probe_gather.cu`` (``lane_gather``) and
``csrc/probe_dfa_step.cu`` (``dfa_step``).  The script's lines without a
Pallas kernel (``xla_scan_gather``, ``xla_big_gather``,
``mxu_bf16_4096``, ``hbm_copy_256MB``) are timed as the torch ops they
name, ``"kernel": null``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu

(``--device cpu`` runs the plain versions at small widths).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness

LANES = 128  # a row's lanes
NB, NS = 256, 128  # the DFA table: bytes x states (the probes' S)
KC = 16  # class_mma's classes at most
STORES = ("shared", "regs")
GATHER_FORMS = ("pow", "serial")
FORMS = ("lookup", "onehot_mma", "class_mma")
PICKS = ("gather", "sum")
B, L = 4096, 1024  # the script's corpus shape (its XLA lines)
BF16_PEAK = 989e12  # the H100 SXM's dense bf16 tensor-core rate (data sheet)


def _ints(t: torch.Tensor, name: str, shape=None) -> None:
    if t.dtype != torch.int32 or (shape is not None and tuple(t.shape) != tuple(shape)):
        want = "int32" if shape is None else f"int32{tuple(shape)}"
        raise ValueError(f"{name}: expected {want}, got {t.dtype}{tuple(t.shape)}")


def _within(t: torch.Tensor, name: str, hi: int) -> None:
    if t.numel() and bool(((t < 0) | (t >= hi)).any()):
        raise ValueError(f"{name}: values must lie in [0, {hi})")


# ----------------------------------------------------------------- lane_gather


def gather_form(form: Optional[str], steps: int) -> str:
    """The form a call runs: ``form``, or where it is None ``"pow"`` past
    one step and ``"serial"`` at 0 or 1 (the same single gather); raises on
    an unknown form."""
    if form is None:
        return "pow" if steps > 1 else "serial"
    if form not in GATHER_FORMS:
        raise ValueError(f"form {form!r}: expected one of {GATHER_FORMS}")
    return form


def _check_gather(g: torch.Tensor, f: torch.Tensor, steps: int, store: str) -> int:
    if g.dim() != 2 or g.shape[0] == 0 or g.shape[1] != LANES:
        raise ValueError(f"g: expected [R, {LANES}] int32, got {g.dtype}{tuple(g.shape)}")
    _ints(g, "g")
    _ints(f, "f", g.shape)
    if steps < 0:
        raise ValueError(f"steps {steps} must not be negative")
    if store not in STORES:
        raise ValueError(f"store {store!r}: expected one of {STORES}")
    return g.shape[0]


def check_gather_ranges(g: torch.Tensor, f: torch.Tensor, steps: int) -> None:
    """The indices stay in the row: f in [0, 128), and with more than one
    step g too (its values are the next step's indices).  On the card it
    waits for the device, so the plain version checks it and the kernel's
    wrapper leaves it to its caller."""
    _within(f, "f", LANES)
    if steps > 1:
        _within(g, "g", LANES)


def pow_rounds(steps: int) -> List[str]:
    """The pow form's dependent rounds in the kernel's order: for each bit
    of ``steps`` from the lowest, ``"apply"`` (acc = p[acc]) where it is
    set, then ``"square"`` (p = p[p]) while a higher bit remains."""
    rounds = []
    while steps:
        if steps & 1:
            rounds.append("apply")
        steps >>= 1
        if steps:
            rounds.append("square")
    return rounds


def lane_gather_plain(g: torch.Tensor, f: torch.Tensor, steps: int = 1,
                      store: str = "shared") -> torch.Tensor:
    """``steps`` rounds of ``take_along_axis(g, acc, -1)`` from acc = f;
    ``store`` does not change it."""
    _check_gather(g, f, steps, store)
    check_gather_ranges(g, f, steps)
    acc = f.clone()
    for _ in range(steps):
        acc = torch.gather(g, 1, acc.long())
    return acc


def lane_gather_pow_plain(g: torch.Tensor, f: torch.Tensor, steps: int = 1,
                          store: str = "shared") -> torch.Tensor:
    """The pow form's function as the kernel computes it: from p = g and
    acc = f, ``pow_rounds(steps)`` in order, each a gather of a whole row;
    ``store`` does not change it."""
    _check_gather(g, f, steps, store)
    check_gather_ranges(g, f, steps)
    p, acc = g.long(), f.long()
    for op in pow_rounds(steps):
        if op == "apply":
            acc = torch.gather(p, 1, acc)
        else:
            p = torch.gather(p, 1, p)
    return acc.to(torch.int32)


def lane_gather_cuda(g: torch.Tensor, f: torch.Tensor, steps: int = 1,
                     store: str = "shared", form: Optional[str] = None) -> torch.Tensor:
    """The ``lane_gather`` kernel in ``form`` (``gather_form``), the row in
    shared memory or registers.  Precondition (``check_gather_ranges``; not
    checked here)."""
    R = _check_gather(g, f, steps, store)
    form = gather_form(form, steps)
    kernels._check(g, "g", torch.int32, (R, LANES))
    kernels._check(f, "f", torch.int32, (R, LANES))
    out = torch.empty_like(g)
    lib = kernels.build_probes()
    kernels._launch(kernels.LANE_GATHER, lib.h2r_lane_gather, g.data_ptr(), f.data_ptr(),
                    out.data_ptr(), R, steps,
                    STORES.index(store) + (3 if form == "pow" else 0), kernels._stream(g))
    return out


def lane_gather(g: torch.Tensor, f: torch.Tensor, steps: int = 1,
                store: str = "shared", form: Optional[str] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (``form`` as ``lane_gather_cuda``'s), the
    plain version on CPU ones."""
    gather_form(form, steps)
    if g.device.type == "cpu":
        return lane_gather_plain(g, f, steps, store)
    return lane_gather_cuda(g, f, steps, store, form)


def _check_rows(t: torch.Tensor, c: torch.Tensor) -> Tuple[int, int]:
    if t.dim() != 2 or t.shape[0] == 0 or t.shape[1] != LANES:
        raise ValueError(f"t: expected [RT, {LANES}] int32, got {t.dtype}{tuple(t.shape)}")
    _ints(t, "t")
    if c.dim() != 1 or c.shape[0] == 0:
        raise ValueError(f"c: expected [R] int32, got {c.dtype}{tuple(c.shape)}")
    _ints(c, "c")
    return t.shape[0], c.shape[0]


def row_gather_plain(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``t[c]``: rows of t by index, c in [0, RT) (checked)."""
    RT, _R = _check_rows(t, c)
    _within(c, "c", RT)
    return t[c.long()]


def row_gather_cuda(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``lane_gather``'s rows mode.  Precondition: c in [0, RT)."""
    RT, R = _check_rows(t, c)
    kernels._check(t, "t", torch.int32, (RT, LANES))
    kernels._check(c, "c", torch.int32, (R,))
    out = torch.empty((R, LANES), dtype=torch.int32, device=t.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.LANE_GATHER, lib.h2r_lane_gather, t.data_ptr(), c.data_ptr(),
                    out.data_ptr(), R, 0, 2, kernels._stream(t))
    return out


def row_gather(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    return row_gather_plain(t, c) if t.device.type == "cpu" else row_gather_cuda(t, c)


# -------------------------------------------------------------------- dfa_step


def _check_dfa(T: torch.Tensor, chars: torch.Tensor, form: str, pick: str,
               classes: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """Shapes and dtypes; returns chars' two sizes and T's rows."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if pick not in PICKS:
        raise ValueError(f"pick {pick!r}: expected one of {PICKS}")
    if form == "class_mma":
        if classes is None:
            raise ValueError("class_mma: expected classes [256] int32")
        if T.dim() != 2 or not 1 <= T.shape[0] <= KC or T.shape[1] != NS:
            raise ValueError(f"Tk: expected [K <= {KC}, {NS}] int32, got "
                             f"{T.dtype}{tuple(T.shape)}")
        _ints(T, "Tk")
        _ints(classes, "classes", (NB,))
    else:
        if classes is not None:
            raise ValueError(f"{form}: takes no classes")
        _ints(T, "T", (NB, NS))
    if chars.dim() != 2 or chars.shape[0] == 0 or chars.shape[1] == 0:
        raise ValueError(f"chars: expected a non-empty 2-D int32 tensor, got "
                         f"{chars.dtype}{tuple(chars.shape)}")
    _ints(chars, "chars")
    return chars.shape[0], chars.shape[1], T.shape[0]


def check_dfa_ranges(T: torch.Tensor, chars: torch.Tensor,
                     classes: Optional[torch.Tensor] = None) -> None:
    """The probes' ranges, the precondition of every form: T's values in
    [0, 128) (a state never leaves the table, and bf16 carries them
    exactly), bytes in [0, 256), classes in [0, K)."""
    _within(T, "T", NS)
    _within(chars, "chars", NB)
    if classes is not None:
        _within(classes, "classes", T.shape[0])


def dfa_table(T: torch.Tensor, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The [256, 128] table a scan walks: T, or Tk[classes] for class_mma."""
    return T if classes is None else T[classes.long()]


def dfa_step_plain(T: torch.Tensor, chars: torch.Tensor, form: str = "lookup",
                   time_major: bool = False, pick: str = "gather",
                   classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The lookup loop ``s = T[c, s]`` from s = 0, one step a position,
    every state in ``chars``' layout; ``form`` and ``pick`` do not change
    it.  It checks the ranges (``check_dfa_ranges``)."""
    _check_dfa(T, chars, form, pick, classes)
    check_dfa_ranges(T, chars, classes)
    flat = dfa_table(T, classes).reshape(-1).long()
    c = chars if time_major else chars.t()  # [LB, TB]
    s = torch.zeros(c.shape[1], dtype=torch.int64, device=chars.device)
    states = []
    for i in range(c.shape[0]):
        s = flat[c[i].long() * NS + s]
        states.append(s)
    out = torch.stack(states).to(torch.int32)
    return out if time_major else out.t().contiguous()


def dfa_step_cuda(T: torch.Tensor, chars: torch.Tensor, form: str = "lookup",
                  time_major: bool = False, pick: str = "gather",
                  classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``dfa_step`` kernel in ``form`` (and ``pick`` for the
    products).  Precondition (``check_dfa_ranges``; not checked here,
    since that waits for the device)."""
    d0, d1, K = _check_dfa(T, chars, form, pick, classes)
    kernels._check(T, "T", torch.int32, tuple(T.shape))
    kernels._check(chars, "chars", torch.int32, (d0, d1))
    if classes is not None:
        kernels._check(classes, "classes", torch.int32, (NB,))
    TB, LB = (d1, d0) if time_major else (d0, d1)
    out = torch.empty_like(chars)
    lib = kernels.build_probes()
    kernels._launch(kernels.DFA_STEP, lib.h2r_dfa_step, T.data_ptr(),
                    None if classes is None else classes.data_ptr(), chars.data_ptr(),
                    out.data_ptr(), TB, LB, int(time_major), FORMS.index(form),
                    PICKS.index(pick), K if form == "class_mma" else 1, kernels._stream(T))
    return out


def dfa_step(T: torch.Tensor, chars: torch.Tensor, form: str = "lookup",
             time_major: bool = False, pick: str = "gather",
             classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if chars.device.type == "cpu":
        return dfa_step_plain(T, chars, form, time_major, pick, classes)
    return dfa_step_cuda(T, chars, form, time_major, pick, classes)


def dfa_work(TB: int, LB: int, form: str, K: int = KC) -> dict:
    """The bytes, operations and tensor-core flops a bound reads: the bytes
    and states in int32, the table once; a lookup (int32) a state; for the
    products also a one-hot row's 256 compares, two a half2 instruction as
    the kernel builds it (HSET2), and its products (f16, whose dense rate
    is bf16's)."""
    table = (K * NS + NB) * 4 if form == "class_mma" else NB * NS * 4
    work = dict(nbytes=2 * TB * LB * 4 + table, int32_ops=TB * LB, shape=[TB, LB])
    if form != "lookup":
        per = NB * NS if form == "onehot_mma" else NB * KC + KC * NS
        work.update(half2_ops=TB * LB * NB // 2, mma_flops=2 * TB * LB * per,
                    mma_peak=BF16_PEAK)
    return work


# ------------------------------------------------------------------------- run


def table(seed: int = 0) -> torch.Tensor:
    """The probes' T [256, 128] int32 in [0, 128), seeded."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, NS, size=(NB, NS)).astype(np.int32))


def gather_inputs(R: int, seed: int = 0, dev: Optional[torch.device] = None):
    """g and f [R, 128] int32 in [0, 128), seeded."""
    rng = np.random.default_rng(seed)
    g, f = (torch.from_numpy(rng.integers(0, LANES, size=(R, LANES)).astype(np.int32))
            for _ in range(2))
    return g.to(dev or "cpu"), f.to(dev or "cpu")


def bytes_(d0: int, d1: int, seed: int = 0, dev: Optional[torch.device] = None,
           lo: int = 0, hi: int = NB) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(lo, hi, size=(d0, d1)).astype(np.int32)).to(dev or "cpu")


def gather_line(timer, card, probe: str, g: torch.Tensor, f: torch.Tensor, steps: int,
                store: str) -> List[dict]:
    """``lane_gather`` measurements (``harness.measure``), a line a form
    past one step (on the CPU the plain version once), else one: ns a step
    is the time over ``steps`` (a step is one gather of every lane).  The
    serial form's int32 work is a gather a lane and step; the pow form's a
    gather a lane and round (``pow_rounds``)."""
    R, fl = g.shape[0], f.long()
    forms = GATHER_FORMS if steps > 1 and g.device.type == "cuda" else (gather_form(None, steps),)
    if len(forms) > 1:
        tp = timer(lambda: lane_gather_plain(g, f, steps, store), 0, 1)
        plain = (tp["out"], tp["median"])
    else:
        plain = lambda: lane_gather_plain(g, f, steps, store)  # noqa: E731
    recs = []
    for form in forms:
        rounds = len(pow_rounds(steps)) if form == "pow" else steps
        recs.append(harness.measure(
            timer, card, probe, kernels.LANE_GATHER,
            lambda: lane_gather(g, f, steps, store, form), max(steps, 1), plain,
            library=(lambda: torch.gather(g, 1, fl)) if steps == 1 else None,
            nbytes=3 * g.numel() * 4, int32_ops=g.numel() * rounds, shape=[R, LANES],
            store=store, form=form, gathers=steps, rounds=rounds)[0])
    return recs


def dfa_line(timer, card, probe: str, T: torch.Tensor, chars: torch.Tensor, form: str,
             time_major: bool, pick: str = "gather",
             classes: Optional[torch.Tensor] = None) -> dict:
    """A ``dfa_step`` measurement: ns a step over the LB steps."""
    TB, LB = (chars.shape[1], chars.shape[0]) if time_major else tuple(chars.shape)
    K = T.shape[0] if form == "class_mma" else KC
    return harness.measure(
        timer, card, probe, kernels.DFA_STEP,
        lambda: dfa_step(T, chars, form, time_major, pick, classes), LB,
        lambda: dfa_step_plain(T, chars, form, time_major, pick, classes),
        form=form, pick=None if form == "lookup" else pick,
        layout="time_major" if time_major else "batch_major",
        **dfa_work(TB, LB, form, K))[0]


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """k3, k4 (each storage form) and k5 (``lane_gather``), k6 and k7
    (``dfa_step``) at the probe's widths (TB = LB = 256, batch-major), and
    its XLA lines as torch ops; ``small``: TB = 32, LB = 64 and small XLA
    lines (the CPU run)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    T = table().to(dev)
    rng = np.random.default_rng(0)
    for probe, R in (("k3_take_along_8x128", 8), ("k4_take_along_256x128", 256)):
        g, f = gather_inputs(R, seed=R, dev=dev)
        for store in STORES:
            recs += gather_line(timer, card, probe, g, f, 1, store)
    c = torch.from_numpy(rng.integers(0, NB, size=8).astype(np.int32)).to(dev)
    cl = c.long()
    recs.append(harness.measure(
        timer, card, "k5_row_gather", kernels.LANE_GATHER, lambda: row_gather(T, c), 1,
        lambda: row_gather_plain(T, c), library=lambda: T[cl],
        nbytes=(2 * 8 * LANES + 8) * 4, int32_ops=8 * LANES, shape=[8, LANES], store="rows",
        gathers=1)[0])
    TB, LB = (32, 64) if small else (256, 256)
    cb = bytes_(TB, LB, seed=6, dev=dev)
    recs.append(dfa_line(timer, card, "k6_onehot_mma_step", T, cb, "onehot_mma", False))
    recs.append(dfa_line(timer, card, "k7_lookup_step", T, cb, "lookup", False))
    # the script's XLA lines
    Bx, Lx = (64, 64) if small else (B, L)
    rows = bytes_(Bx, Lx, seed=1, dev=dev).long() * NS
    flat = T.reshape(-1)

    def xla_scan():  # lax.scan of a flat take a position
        s = torch.zeros(Bx, dtype=torch.int64, device=dev)
        seq = []
        for i in range(Lx):
            s = torch.take(flat, rows[:, i] + s).long()
            seq.append(s)
        return torch.stack(seq)

    rec, _ = harness.torch_line(timer, card, "xla_scan_gather", xla_scan, shape=[Bx, Lx])
    recs.append(rec)
    idx = bytes_(Bx, Lx, seed=2, dev=dev, hi=NB * NS).long()
    rec, _ = harness.torch_line(timer, card, "xla_big_gather", lambda: torch.take(flat, idx),
                                shape=[Bx, Lx])
    recs.append(rec)
    n = 256 if small else 4096
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(dev, torch.bfloat16)
    rec, _ = harness.torch_line(timer, card, f"mxu_bf16_{n}", lambda: torch.matmul(a, a),
                                shape=[n, n], flops=2 * n**3)
    recs.append(rec)
    size = 1 << (20 if small else 28)
    x = torch.from_numpy(rng.integers(0, 255, size=size).astype(np.uint8)).to(dev)
    rec, _ = harness.torch_line(timer, card, f"hbm_copy_{size >> 20}MB", lambda: x + 1,
                                nbytes=2 * size)
    recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu.py's probes: lane_gather (k3, k4, k5) and dfa_step "
                       "(k6, k7) at the probe's widths (the CPU: small ones)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
