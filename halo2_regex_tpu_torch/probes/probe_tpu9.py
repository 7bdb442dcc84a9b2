"""tools/probe_tpu9.py's A, B and C on the H100: what a serial loop's step
costs with its rows in shared memory, and what the probe's table step
costs.

- ``loop_floor(x, slab)``: ``o[i] = x[i] + o[i - 1]`` down the rows of x
  [L, TB] int32, int32 sums that wrap (JAX's adds); slab 1 is the probe's
  A (``ka``), slab 8 its B (``kb``: eight rows a loop step).
- ``slab_scan(tk, classes, x)``: the probe's C (``kc``): per step the
  class of byte x[i, b], then ``v_j = tk[class, j * S + s]`` for j = 0..3
  and ``s = v_0`` from s = 0; four [L, TB] int32 outputs.

The kernels are ``csrc/probe_tpu9.cu`` (``loop_floor``, ``slab_scan``), each
in two forms (``form``): ``"chunked"``, the default, a scan over tiles of
rows with a decoupled look-back that fills the card, and ``"serial"``, a
thread a column walking its rows, whose step chip_smoke's [10] sets beside
configs[3]'s table-scan chain.  The slab kernel's chunked form needs S <=
32 (``kernels.slab_form``).  Their torch twins, ``loop_floor_chunks_plain``
and ``slab_chunks_plain``, compute what the chunked forms compute, phase
by phase.  Run on the card::

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


def scan_form(form: Optional[str], S: int = 0) -> str:
    """The form a call runs: ``form``, or where it is None the default,
    ``"chunked"`` (for the slab kernel ``kernels.slab_form(S)``'s).  Raises
    on an unknown form and on ``"chunked"`` past ``kernels.SLAB_CHUNK_MAX_S``
    states."""
    if form is None:
        return kernels.slab_form(S)
    if form not in kernels.SCAN_FORMS:
        raise ValueError(f"form {form!r}: expected one of {kernels.SCAN_FORMS}")
    if form == "chunked" and S > kernels.SLAB_CHUNK_MAX_S:
        raise ValueError(f"form 'chunked' needs S <= {kernels.SLAB_CHUNK_MAX_S}, got S = {S}")
    return form


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 sums cut to int32, as adds that wrap leave them."""
    return (torch.remainder(v + 2**31, 2**32) - 2**31).to(torch.int32)


def loop_floor_plain(x: torch.Tensor, slab: int = 1) -> torch.Tensor:
    """The running sum down dim 0 in int32 that wraps as JAX's adds do
    (summed in int64, then cut to 32 bits); ``slab`` does not change it."""
    _check_floor(x, slab)
    return _wrap(torch.cumsum(x.to(torch.int64), 0))


def loop_floor_chunks_plain(x: torch.Tensor, C: int) -> torch.Tensor:
    """``loop_floor``'s chunked form (``floor_chunk_kernel``) phase by
    phase: each tile of C rows' column sums, an exclusive prefix over the
    tiles of each column (what the look-back gives a tile), then each
    tile's running sum plus its prefix.  Rows past L count as 0."""
    L_, TB_ = _check_floor(x, 1)
    n = -(-L_ // C)
    tiles = torch.zeros((n * C, TB_), dtype=torch.int64, device=x.device)
    tiles[:L_] = x
    tiles = tiles.reshape(n, C, TB_)
    sums = _wrap(tiles.sum(1)).to(torch.int64)  # [n, TB]
    before = _wrap(torch.cumsum(sums, 0) - sums).to(torch.int64)
    out = torch.cumsum(tiles, 1) + before[:, None]
    return _wrap(out.reshape(n * C, TB_)[:L_])


def loop_floor_cuda(x: torch.Tensor, slab: int = 1, form: Optional[str] = None) -> torch.Tensor:
    """The ``loop_floor`` kernel, ``slab`` rows a loop step (1 or 8) in the
    serial form; the chunked form (the default) computes the same sums
    whatever ``slab`` is, over tiles of ``kernels.scan_chunk``'s rows."""
    L_, TB_ = _check_floor(x, slab)
    form = scan_form(form)
    kernels._check(x, "x", torch.int32, (L_, TB_))
    out = torch.empty_like(x)
    lib = kernels.build_probes()
    c, scratch, epoch = 0, None, 0
    if form == "chunked":
        c = kernels.scan_chunk(L_, TB_, x.device)
        if x.numel() == 0:
            return out
        scratch, epoch = kernels.lookback_scratch(kernels.LOOP_FLOOR, x,
                                                  -(-TB_ // 32) * -(-L_ // c))
    kernels._launch(kernels.LOOP_FLOOR, lib.h2r_loop_floor, x.data_ptr(), out.data_ptr(), slab,
                    L_, TB_, c, scratch, epoch, kernels._stream(x))
    return out


def loop_floor(x: torch.Tensor, slab: int = 1, form: Optional[str] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor (``form`` as ``loop_floor_cuda``'s), the
    plain version on a CPU one."""
    scan_form(form)
    return loop_floor_plain(x, slab) if x.device.type == "cpu" else loop_floor_cuda(x, slab, form)


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


def compose_maps(acc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``acc o m`` along the last dim: ``acc[m[j]]`` (the kernel's shuffle
    of acc by m)."""
    return torch.gather(acc, -1, m)


def slab_chunk_maps(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, C: int,
                    n_sub: int = kernels.SLAB_CHUNK_WARPS):
    """Phase 2 of the slab kernel's chunked form: each string's walk of each
    chunk of C positions from every start state j in [0, S).  Positions
    past L take byte 0, as the kernel stages them.  Returns the chunks'
    maps, the end states [n_ch, TB, S], and the states recorded at each
    sub-chunk's start [n_ch, n_sub, TB, S] (sub-chunk 0's is j), int64."""
    _k, s_ = check_table(tk, classes)
    L_, TB_ = x.shape
    if C % n_sub:
        raise ValueError(f"C {C}: expected a multiple of n_sub = {n_sub}")
    n_ch = -(-L_ // C)
    xs = torch.zeros((n_ch * C, TB_), dtype=torch.int64, device=x.device)
    xs[:L_] = x
    flat = tk.reshape(-1).to(torch.int64)
    base = (classes[xs.clamp(0, 255)].to(torch.int64) * (4 * s_)).reshape(n_ch, C, TB_, 1)
    s = torch.arange(s_, device=x.device).expand(n_ch, TB_, s_)
    marks = []
    for i in range(C):
        if i % (C // n_sub) == 0:
            marks.append(s)
        s = flat[base[:, i] + s]
    return s, torch.stack(marks, 1)


def slab_chunk_starts(maps: torch.Tensor, first: int, depth: Optional[int] = None):
    """Phase 3: each chunk's start state a string [n_ch, TB], as the
    look-back finds it.  Chunk 0 starts at ``first``; chunk r composes the
    maps of the ``depth`` chunks before it (all where None or fewer are
    left), r - 1 first, ``acc = acc o m_k``, and applies the composition to
    the end state it then meets, chunk r - depth - 1's (or to ``first``).
    Whatever the depth, the start states are the same."""
    n_ch, TB_, _s = maps.shape
    first_ = torch.full((TB_, 1), first, dtype=torch.int64, device=maps.device)
    starts, ends = [first_], [torch.gather(maps[0], 1, first_)]
    ident = torch.arange(maps.shape[2], device=maps.device).expand(TB_, -1)
    for r in range(1, n_ch):
        d = r if depth is None else min(depth, r)
        acc = ident
        for k in range(r - 1, r - d - 1, -1):
            acc = compose_maps(acc, maps[k])
        met = ends[r - d - 1] if r > d else first_
        starts.append(torch.gather(acc, 1, met))
        ends.append(torch.gather(maps[r], 1, starts[r]))
    return torch.cat(starts, 1).t()


def slab_chunk_replay(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor,
                      starts: torch.Tensor, marks: torch.Tensor, n_out: int, C: int):
    """Phase 4: each (chunk, sub-chunk, string) from the state recorded at
    its sub-chunk's start for its chunk's start state, walked with the
    ``n_out`` picks; the outputs [L, TB] int32."""
    _k, s_ = check_table(tk, classes)
    L_, TB_ = x.shape
    n_ch, n_sub = marks.shape[:2]
    sub = C // n_sub
    xs = torch.zeros((n_ch * C, TB_), dtype=torch.int64, device=x.device)
    xs[:L_] = x
    flat = tk.reshape(-1).to(torch.int64)
    base = (classes[xs.clamp(0, 255)].to(torch.int64) * (4 * s_)).reshape(n_ch, n_sub, sub, TB_)
    s = torch.gather(marks, 3, starts[:, None, :, None].expand(n_ch, n_sub, TB_, 1))[..., 0]
    outs = [torch.empty((n_ch, n_sub, sub, TB_), dtype=torch.int64, device=x.device)
            for _ in range(n_out)]
    for i in range(sub):
        for j in range(n_out):
            outs[j][:, :, i] = flat[base[:, :, i] + j * s_ + s]
        s = outs[0][:, :, i]
    return tuple(o.reshape(n_ch * C, TB_)[:L_].to(torch.int32) for o in outs)


def slab_chunks_plain(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int = 0,
                      n_out: int = 4, C: int = 256, n_sub: int = kernels.SLAB_CHUNK_WARPS,
                      depth: Optional[int] = None):
    """The slab kernel's chunked form (``slab_chunk_kernel``) phase by
    phase: the maps over every start state and the recorded sub-chunk
    states (``slab_chunk_maps``), their composition in chunk order from
    ``first`` (``slab_chunk_starts``, with the look-back reading ``depth``
    maps back), and the replay from the records (``slab_chunk_replay``).
    The same outputs as ``slab_plain``."""
    _check_x(x)
    maps, marks = slab_chunk_maps(tk, classes, x, C, n_sub)
    starts = slab_chunk_starts(maps, first, depth)
    return slab_chunk_replay(tk, classes, x, starts, marks, n_out, C)


def slab_launch(kernel: kernels.CudaKernel, tk: torch.Tensor, classes: torch.Tensor,
                x: torch.Tensor, first: int, n_out: int, form: Optional[str]) -> tuple:
    """Launch the slab kernel by ``kernel``'s entry (``h2r_slab_scan``,
    without ``first`` and ``n_out``, or ``h2r_slab_anatomy``) in ``form`` on new
    outputs, its launch counted on ``kernel``; the chunked form over tiles
    of ``kernels.scan_chunk``'s positions."""
    k, s = check_table(tk, classes)
    L_, TB_ = _check_x(x)
    form = scan_form(form, s)
    kernels._check(tk, "tk", torch.int32, (k, 4 * s))
    kernels._check(classes, "classes", torch.int32, (256,))
    kernels._check(x, "x", torch.int32, (L_, TB_))
    outs = tuple(torch.empty_like(x) for _ in range(n_out))
    c, scratch, epoch = 0, None, 0
    if form == "chunked":
        c = kernels.scan_chunk(L_, TB_, x.device)
        if TB_ == 0:
            return outs
        scratch, epoch = kernels.lookback_scratch(kernel, x, -(-TB_ // 32) * -(-L_ // c))
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - n_out)
    extra = () if kernel is kernels.SLAB_SCAN else (first, n_out)
    entry = getattr(kernels.build_probes(), kernel.entry)
    kernels._launch(kernel, entry, tk.data_ptr(), classes.data_ptr(), x.data_ptr(), *ptrs, L_,
                    TB_, k, s, *extra, c, scratch, epoch, kernels._stream(x))
    return outs


def slab_scan_plain(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor):
    """The probe's C (``slab_plain`` from state 0, four outputs).  It
    checks the tables' ranges (``check_ranges``)."""
    check_ranges(tk, classes)
    return slab_plain(tk, classes, x)


def slab_scan_cuda(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor,
                   form: Optional[str] = None):
    """The ``slab_scan`` kernel in ``form`` (None: ``kernels.slab_form``'s):
    the same four outputs as
    ``slab_scan_plain``.  Precondition (``check_ranges``; not checked here,
    since that waits for the device): tk's values lie in [0, S) and
    classes' in [0, K); outside them the kernel reads past its table."""
    return slab_launch(kernels.SLAB_SCAN, tk, classes, x, 0, 4, form)


def slab_scan(tk: torch.Tensor, classes: torch.Tensor, x: torch.Tensor,
              form: Optional[str] = None):
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        scan_form(form, check_table(tk, classes)[1])
        return slab_scan_plain(tk, classes, x)
    return slab_scan_cuda(tk, classes, x, form)


def inputs(L_: int, TB_: int, seed: int = 0, dev: Optional[torch.device] = None):
    """The probe's inputs, seeded: bytes x [L, TB] in [0, 256), a class
    map [256] in [0, K) and a table tk [K, 4S] in [0, S), all int32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(L_, TB_)).astype(np.int32)
    classes = rng.integers(0, K, size=256).astype(np.int32)
    tk = rng.integers(0, S, size=(K, 4 * S)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (x, classes, tk))


def run(dev: torch.device, widths: Sequence[Tuple[int, int]] = ((L, TB),),
        scan_widths: Optional[Sequence[Tuple[int, int]]] = None,
        serial_widths: Sequence[Tuple[int, int]] = ()) -> List[dict]:
    """A and B (``loop_floor``, slab 1 and 8) at each [L, TB] of ``widths``,
    with ``torch.cumsum`` beside them, and C (``slab_scan``) at those of
    ``scan_widths`` (default: all), each in its default form, and at those
    of ``serial_widths`` in the serial form too: a line each
    (``harness.measure``; its ``form``)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    scan_widths = widths if scan_widths is None else scan_widths
    recs = []
    for L_, TB_ in widths:
        x, classes, tk = inputs(L_, TB_, dev=dev)
        work = dict(nbytes=2 * x.numel() * 4, int32_ops=x.numel(), shape=[L_, TB_])
        forms = kernels.SCAN_FORMS if (L_, TB_) in serial_widths else (scan_form(None),)
        for form in forms:
            for probe, slab in (("A_loop_floor", 1), ("B_slab8_floor", SLAB)):
                recs.append(harness.measure(
                    timer, card, probe, kernels.LOOP_FLOOR, lambda: loop_floor(x, slab, form),
                    L_, lambda: loop_floor_plain(x, slab),
                    library=lambda: torch.cumsum(x, 0, dtype=torch.int32), slab=slab, form=form,
                    **work)[0])
        if (L_, TB_) not in scan_widths:
            continue
        for form in kernels.SCAN_FORMS if (L_, TB_) in serial_widths else (scan_form(None, S),):
            recs.append(harness.measure(
                timer, card, "C_slab8_scan", kernels.SLAB_SCAN,
                lambda: slab_scan(tk, classes, x, form), L_,
                lambda: slab_scan_plain(tk, classes, x),
                nbytes=(5 * x.numel() + tk.numel() + classes.numel()) * 4,
                int32_ops=5 * x.numel(), shape=[L_, TB_], K=K, S=S, form=form)[0])
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
