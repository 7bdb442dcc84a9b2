"""tools/probe_tpu28.py's bisects on the H100, and the widened DFA step
that every configs[3] table-step probe runs.

- ``dfa_wide(tbl, chars, hilo, cmod, smod, entry, form)``: the DFA scan
  ``s = next(c, s)`` on a table of up to 256 classes x 1024 states, one
  state written a position.  ``tbl`` [K, W] bf16 is the table as the
  probes' bodies read it (``tbl_ref[:].astype(jnp.bfloat16)``:
  ``as_table`` rounds an f32 table the same way); W = S, or 2S with
  ``hilo`` (lo columns [0, S), hi columns [S, 2S), next = lo + 256 hi).
  chars [L, TB] int32 time-major, each the class itself or, with
  ``cmod``, ``c mod K``; ``smod`` takes the next state mod S; ``entry``
  [TB] int32 is the state before position 0 (zeros by default).  A class
  outside [0, K) or a state outside [0, S) gives next state 0 (the probes'
  one-hot and select then have no term).  out [L, TB] int32; its last row
  is the exit state, the entry of a launch that continues the scan.
  ``form``: ``"lookup"`` (the decoded table in shared memory, or read from
  global memory where it does not fit), ``"onehot_mma"`` (the probes'
  method: the one-hot of the classes times all W columns on the tensor
  cores, then the pick of column s) or ``"count"`` (v1: ``out[t] = T[c, 0]
  + t + entry``, no chain).  Every form gives the same states.

The probe's own lines: v1 (``count``: ``c mod 96``, column 0 plus the
position) and v2 (hi/lo, ``c mod 96``, ``s mod S``: the configs[3] step)
at K = 96, S = 1008, [4096, 128] chars in [32, 127), the table [96, 2016]
in [0, 256).  ``configs3_lines`` runs the step at configs[3]'s batch (B=64
x L=65536, 96 classes x 1008 states) beside B8's table scan
(``kernels.table_scan_cuda``) on the same table.  The kernel is
``csrc/probe_dfa_wide.cu``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu28

(``--device cpu`` runs the plain versions at [256, 16]).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu import BF16_PEAK

FORMS = ("lookup", "onehot_mma", "count")
TB, K, S = 128, 96, 1008  # the probe's strings, classes and states
L = 4096  # its 4 chunks of 1024
MAX_K, MAX_S = 256, 1024
# the lookup kernel's shared memory past its table: its four scanning
# warps' rings (csrc/probe_dfa_wide.cu: 4 x 8 x 8 x 32 x 4 bytes)
LOOKUP_RING_BYTES = 4 * 8 * 8 * 32 * 4


def as_table(tbl) -> torch.Tensor:
    """A table (numpy or torch, any real dtype) as the probes' bodies read
    it: rounded to bf16 (to nearest, ties to even, as XLA's astype)."""
    t = torch.from_numpy(np.array(tbl)) if isinstance(tbl, np.ndarray) else torch.as_tensor(tbl)
    return t.to(torch.float32).to(torch.bfloat16).contiguous()


def _check(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool, form: str,
           entry: Optional[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    """Shapes and dtypes; returns (K, W, S, L, TB)."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    if tbl.dim() != 2 or tbl.dtype != torch.bfloat16 or 0 in tbl.shape:
        raise ValueError(f"tbl: expected a [K, W] bf16 tensor, got {tbl.dtype}{tuple(tbl.shape)}")
    K_, W = tbl.shape
    if hilo and W % 2:
        raise ValueError(f"tbl [{K_}, {W}]: a hi/lo table has 2S columns")
    S_ = W // 2 if hilo else W
    if K_ > MAX_K or S_ > MAX_S:
        raise ValueError(f"tbl: at most {MAX_K} classes and {MAX_S} states, got {K_} x {S_}")
    if chars.dim() != 2 or chars.dtype != torch.int32 or 0 in chars.shape:
        raise ValueError(f"chars: expected a non-empty [L, TB] int32 tensor, got "
                         f"{chars.dtype}{tuple(chars.shape)}")
    L_, TB_ = chars.shape
    if entry is not None and (tuple(entry.shape) != (TB_,) or entry.dtype != torch.int32):
        raise ValueError(f"entry: expected [{TB_}] int32, got {entry.dtype}{tuple(entry.shape)}")
    return K_, W, S_, L_, TB_


def check_ranges(tbl: torch.Tensor, hilo: bool) -> None:
    """The table's values, the precondition of every form: integers in [0,
    65536), in [0, 256) for a hi/lo table (so a next state fits 16 bits).
    On the card it waits for the device, so the plain version checks it and
    the kernel's wrapper leaves it to its caller."""
    v = tbl.float()
    hi = 256 if hilo else 65536
    if bool(((v < 0) | (v >= hi) | (v != v.floor())).any()):
        raise ValueError(f"tbl: values must be integers in [0, {hi})")


def next_states(tbl: torch.Tensor, hilo: bool = False, smod: bool = False) -> torch.Tensor:
    """The decoded step [K + 1, S + 1] int64: next[c, s] for c < K, s < S,
    and 0 in the last row and column (a class or state out of range)."""
    K_, W = tbl.shape
    S_ = W // 2 if hilo else W
    v = tbl.float().to(torch.int64)
    nxt = v[:, :S_] + 256 * v[:, S_:] if hilo else v
    if smod:
        nxt = nxt % S_
    full = torch.zeros((K_ + 1, S_ + 1), dtype=torch.int64, device=tbl.device)
    full[:K_, :S_] = nxt
    return full


def _classes(chars: torch.Tensor, K_: int, cmod: bool) -> torch.Tensor:
    """The row of each char in ``next_states``: its class, K out of range."""
    c = torch.remainder(chars.long(), K_) if cmod else chars.long()
    return torch.where((c >= 0) & (c < K_), c, K_)


def dfa_wide_plain(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool = False,
                   cmod: bool = False, smod: bool = False,
                   entry: Optional[torch.Tensor] = None, form: str = "lookup") -> torch.Tensor:
    """The lookup loop on ``next_states``, one step a position (``count``:
    column 0 plus the position and the entry); ``form`` does not change
    it otherwise.  It checks the table's ranges (``check_ranges``)."""
    K_, _W, S_, L_, TB_ = _check(tbl, chars, hilo, form, entry)
    check_ranges(tbl, hilo)
    cls = _classes(chars, K_, cmod)
    s = (torch.zeros(TB_, dtype=torch.int64, device=chars.device) if entry is None
         else entry.long())
    if form == "count":
        col = torch.zeros(K_ + 1, dtype=torch.int64, device=chars.device)
        col[:K_] = tbl[:, 0].float().to(torch.int64)
        pos = torch.arange(L_, dtype=torch.int64, device=chars.device)[:, None]
        wide = col[cls] + pos + s[None, :]
        return (torch.remainder(wide + 2**31, 2**32) - 2**31).to(torch.int32)
    flat = next_states(tbl, hilo, smod).reshape(-1)
    rows = cls * (S_ + 1)
    out = []
    for i in range(L_):
        s = flat[rows[i] + torch.where((s >= 0) & (s < S_), s, S_)]
        out.append(s)
    return torch.stack(out).to(torch.int32)


def b_fragments(tbl: torch.Tensor) -> torch.Tensor:
    """The B fragments of ``tbl`` in the order the product form streams
    them: [ceil(W / 8), ceil(K / 16), 32 lanes, 4] int16 (bf16 bits), lane
    4 n8 + q holding rows k, k + 1, k + 8, k + 9 (k = 16 kt + 2 q) of
    column 8 nt + n8, zero past K and W.  The same for every string: made
    once a table (``dfa_wide`` makes it when not given)."""
    K_, W = tbl.shape
    kt, nt = -(-K_ // 16), -(-W // 8)
    bits = torch.zeros((kt * 16, nt * 8), dtype=torch.int16, device=tbl.device)
    bits[:K_, :W] = tbl.contiguous().view(torch.int16)
    # k = 16 kt + 8 h + 2 q + e, n = 8 nt + n8 -> [nt, kt, n8, q, h, e]
    x = bits.view(kt, 2, 4, 2, nt, 8).permute(4, 0, 5, 2, 1, 3)
    return x.contiguous().view(nt, kt, 32, 4)


def table_in_smem(K_: int, S_: int, dev: torch.device) -> bool:
    """Whether the lookup form holds the decoded table in shared memory:
    its K S uint16 (in 16-byte units) beside four warps' rings within the
    card's per-block opt-in."""
    need = -(-K_ * S_ * 2 // 16) * 16 + LOOKUP_RING_BYTES
    return need <= torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def dfa_wide_cuda(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool = False,
                  cmod: bool = False, smod: bool = False,
                  entry: Optional[torch.Tensor] = None, form: str = "lookup",
                  frags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``dfa_wide`` kernel in ``form``.  ``frags``: ``b_fragments(tbl)``
    for the product form (made here when not given); the lookup form's
    table in shared memory where it fits (``table_in_smem``), else in
    global memory.  Precondition (``check_ranges``; not checked here)."""
    K_, W, S_, L_, TB_ = _check(tbl, chars, hilo, form, entry)
    kernels._check(tbl, "tbl", torch.bfloat16, (K_, W))
    kernels._check(chars, "chars", torch.int32, (L_, TB_))
    dev = chars.device
    if entry is None:
        entry = torch.zeros(TB_, dtype=torch.int32, device=dev)
    kernels._check(entry, "entry", torch.int32, (TB_,))
    if form == "onehot_mma":
        if frags is None:
            frags = b_fragments(tbl)
        kernels._check(frags, "frags", torch.int16, (-(-W // 8), -(-K_ // 16), 32, 4))
        kernels._check_aligned(frags, "frags", 8)
    else:
        frags = None
    smem = form == "lookup" and table_in_smem(K_, S_, dev)
    out = torch.empty((L_, TB_), dtype=torch.int32, device=dev)
    lib = kernels.build_probes()
    with torch.cuda.device(dev):
        kernels._launch(kernels.DFA_WIDE, lib.h2r_dfa_wide, tbl.data_ptr(),
                        None if frags is None else frags.data_ptr(), chars.data_ptr(),
                        entry.data_ptr(), out.data_ptr(), TB_, L_, K_, W, int(hilo), int(cmod),
                        int(smod), FORMS.index(form), int(smem), kernels._stream(chars))
    return out


def dfa_wide(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool = False, cmod: bool = False,
             smod: bool = False, entry: Optional[torch.Tensor] = None, form: str = "lookup",
             frags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if chars.device.type == "cpu":
        return dfa_wide_plain(tbl, chars, hilo, cmod, smod, entry, form)
    return dfa_wide_cuda(tbl, chars, hilo, cmod, smod, entry, form, frags)


def wide_work(K_: int, W: int, L_: int, TB_: int, form: str) -> dict:
    """The bytes, int32 operations and tensor-core flops a bound reads: the
    chars in and states out in int32, the table once as bf16; a lookup a
    state, or for the product its mma.sync flops (16-row tiles of the
    strings, 16-row k tiles of the classes, 8-column n tiles)."""
    work = dict(nbytes=2 * L_ * TB_ * 4 + K_ * W * 2 + TB_ * 4, int32_ops=L_ * TB_)
    if form == "onehot_mma":
        tiles = -(-TB_ // 16) * -(-K_ // 16) * -(-W // 8)
        work.update(mma_flops=2 * 16 * 16 * 8 * tiles * L_, mma_peak=BF16_PEAK)
    return work


def wide_line(timer, card, probe: str, tbl: torch.Tensor, chars: torch.Tensor, form: str,
              plain, hilo: bool = False, cmod: bool = False, smod: bool = False,
              entry: Optional[torch.Tensor] = None, **kw) -> Tuple[dict, torch.Tensor]:
    """A ``dfa_wide`` measurement (``harness.measure``; ns a step over L),
    the product's fragments made once beforehand and its runs 1 + 3;
    ``plain`` as measure's (one plain output shared by a probe's forms)."""
    K_, W = tbl.shape
    L_, TB_ = chars.shape
    frags = b_fragments(tbl) if form == "onehot_mma" and chars.is_cuda else None
    extra = {}
    if chars.is_cuda and form == "lookup":
        extra["table"] = "shared" if table_in_smem(K_, W // 2 if hilo else W,
                                                   chars.device) else "global"
    if form == "onehot_mma":  # the slow form: fewer runs
        kw = {"warmup": 1, "iters": 3, **kw}
    return harness.measure(
        timer, card, probe, kernels.DFA_WIDE,
        lambda: dfa_wide(tbl, chars, hilo, cmod, smod, entry, form, frags), L_, plain,
        form=form, shape=[L_, TB_], K=K_, S=W // 2 if hilo else W, hilo=hilo, cmod=cmod,
        smod=smod, **extra, **wide_work(K_, W, L_, TB_, form), **kw)


def plain_once(timer, fn) -> Tuple[torch.Tensor, float]:
    """A plain version's output and ms, taken once (``measure``'s
    ``plain``), for every form of one probe."""
    t = timer(fn, 0, 1)
    return t["out"], t["median"]


def probe_inputs(L_: int, TB_: int, seed: int = 0, dev: Optional[torch.device] = None):
    """The probe's data, seeded as it draws it: tbl [96, 2016] f32 in [0,
    256) as bf16, then chars [L, TB] in [32, 127)."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 256, size=(K, 2 * S)).astype(np.float32)
    chars = rng.integers(32, 127, size=(L_, TB_)).astype(np.int32)
    return as_table(tbl).to(dev or "cpu"), torch.from_numpy(chars).to(dev or "cpu")


def run(dev: torch.device, L_: int = L, TB_: int = TB) -> List[dict]:
    """v1 (``count``) and v2 (hi/lo, ``c mod K``, ``s mod S``; lookup and
    onehot_mma against one plain output) at [L, TB]: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    tbl, chars = probe_inputs(L_, TB_, dev=dev)
    # v1 reads the table's first S columns (tbl_ref[:, 0:S]), and of them column 0
    t1 = tbl[:, :S].contiguous()
    recs = [wide_line(timer, card, "v1_fori_matmul_scratch", t1, chars, "count",
                      lambda: dfa_wide_plain(t1, chars, cmod=True, form="count"), cmod=True)[0]]
    flags = dict(hilo=True, cmod=True, smod=True)
    want = plain_once(timer, lambda: dfa_wide_plain(tbl, chars, **flags))
    for form in ("lookup", "onehot_mma"):
        recs.append(wide_line(timer, card, "v2_select_extract_slab", tbl, chars, form, want,
                              **flags)[0])
    return recs


def configs3_lines(dev: torch.device, next_table: torch.Tensor, cmap: torch.Tensor,
                   chars: torch.Tensor, first: int) -> List[dict]:
    """The widened step at configs[3]'s batch beside B8: the model's next
    table [96, 1008] (< 1008, so split hi/lo it is exact in bf16) and class
    map [256], its chars [B, L] uint8, from its first state.  Lookup and
    onehot_mma (time-major classes [L, B]) and B8's ``table_scan_cuda``
    (its own layout and form) are held against one plain output; B8's line
    is a ``table_scan`` kernel line."""
    timer, card = harness.Timer(dev), harness.card(dev)
    nt = next_table.to(dev)
    tbl = as_table(torch.cat([nt & 255, nt >> 8], 1))
    B_, L_ = chars.shape
    cls = cmap.to(dev).long()[chars.long()].t().contiguous().to(torch.int32)
    entry = torch.full((B_,), first, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    want = dfa_wide_plain(tbl, cls, hilo=True, entry=entry)
    torch.cuda.synchronize(dev)
    want = (want, (time.perf_counter() - t0) * 1e3)
    recs = []
    for form in ("lookup", "onehot_mma"):
        runs = dict(warmup=0, iters=1) if form == "onehot_mma" else {}
        recs.append(wide_line(timer, card, "configs3", tbl, cls, form, want, hilo=True,
                              entry=entry, **runs)[0])
    cm = cmap.to(dev).reshape(1, 256).to(torch.int32).contiguous()
    nt3 = nt.reshape(1, *nt.shape).to(torch.int32).contiguous()
    init = entry.reshape(1, B_)
    n16 = (nt3 * 2).to(torch.int16)  # the matcher's next_table16
    form = kernels.table_scan_form(1, B_, L_, dev)

    def b8():
        out = torch.empty((1, L_, B_), dtype=torch.int32, device=dev)
        kernels.table_scan_cuda(cm, nt3, chars, init, 0, L_, out, next16=n16)
        return out[0]

    recs.append(harness.measure(
        timer, card, "configs3_b8", kernels.TABLE_SCAN, b8, L_, want, calls=2 if form[0] else 1,
        nbytes=2 * L_ * B_ * 4, int32_ops=L_ * B_, shape=[L_, B_], K=nt.shape[0],
        S=nt.shape[1], form=f"b8 {'chunked' if form[0] else 'serial'}")[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu28.py's v1 and v2: the widened DFA step (dfa_wide) at "
                       f"K={K}, S={S}, [{L}, {TB}] (the CPU: [256, 16])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 256, 16) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
