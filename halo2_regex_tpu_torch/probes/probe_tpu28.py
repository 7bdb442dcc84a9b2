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
  ``form``, every one giving the same states:

  - ``"lookup"``: a thread walks a string on the decoded table (in
    shared memory, or read from global memory where it does not fit).
    Serial where the strings fill the card; where they are fewer than
    four warps an SM and L > 2 (W + C) (``lookup_form``: B8's rule, C =
    512, W = 8192) chunked as B8's scan is, two launches: S1 walks each
    chunk of C positions after a warm-up of W, S2 repairs wrong guesses
    (``lookup_repaired`` counts the positions; ``lookup_chunks_plain`` is
    its twin in torch).
  - ``"onehot_mma"``: the probes' method: each step the one-hot of 64
    strings' classes times all W columns of T on the tensor cores
    (wgmma), the columns split over a cluster of ceil(W / 128) blocks (up
    to 16), each holding its slice in shared memory (from ``b_fragments``);
    the holder of column s (and S + s) picks it and writes it to every
    block, one cluster barrier a step.
  - ``"count"`` (v1): ``out[t] = T[c, 0] + t + entry``, no chain.

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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu import BF16_PEAK

FORMS = ("lookup", "onehot_mma", "count")
TB, K, S = 128, 96, 1008  # the probe's strings, classes and states
L = 4096  # its 4 chunks of 1024
MAX_K, MAX_S = 256, 1024
# the lookup kernel's shared memory past its table: up to four walking
# warps' shallowest rings (csrc/probe_dfa_wide.cu: 4 warps x 4 groups x 16
# positions x 32 strings x 4 bytes)
LOOKUP_RING_BYTES = 4 * 4 * 16 * 32 * 4
_REPAIRED: Dict[int, torch.Tensor] = {}  # the chunked lookup's counter, a device


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
    """The product form's operand, ``tbl`` as mma B fragments: [ceil(W /
    8), ceil(K / 16), 32 lanes, 4] int16 (bf16 bits), lane 4 n8 + q holding
    rows k, k + 1, k + 8, k + 9 (k = 16 kt + 2 q) of column 8 nt + n8, zero
    past K and W; each rank of the kernel's cluster stages its columns from
    it.  The same for every string: made once a table (``dfa_wide`` makes
    it when not given)."""
    K_, W = tbl.shape
    kt, nt = -(-K_ // 16), -(-W // 8)
    bits = torch.zeros((kt * 16, nt * 8), dtype=torch.int16, device=tbl.device)
    bits[:K_, :W] = tbl.contiguous().view(torch.int16)
    # k = 16 kt + 8 h + 2 q + e, n = 8 nt + n8 -> [nt, kt, n8, q, h, e]
    x = bits.view(kt, 2, 4, 2, nt, 8).permute(4, 0, 5, 2, 1, 3)
    return x.contiguous().view(nt, kt, 32, 4)


def table_in_smem(K_: int, S_: int, dev: torch.device) -> bool:
    """Whether the lookup form holds the decoded table in shared memory:
    its (K + 1)(S + 1) uint16 (in 16-byte units) beside four warps' rings
    within the card's per-block opt-in."""
    need = -(-(K_ + 1) * (S_ + 1) * 2 // 16) * 16 + LOOKUP_RING_BYTES
    return need <= torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def lookup_form(TB_: int, L_: int, dev: torch.device) -> Tuple[int, int]:
    """``(C, W)`` of the lookup's chunked form (speculate, then repair), or
    ``(0, 0)`` for its serial form: B8's rule (``kernels.table_scan_form``
    of one def: fewer than four warps of strings an SM and L > 2 (W + C))."""
    return kernels.table_scan_form(1, TB_, L_, dev)


def wide_launches(TB_: int, L_: int, form: str, dev: torch.device) -> int:
    """The kernel launches of one ``dfa_wide`` call on the card: two for
    the chunked lookup (S1, S2), else one."""
    return 2 if form == "lookup" and lookup_form(TB_, L_, dev)[0] else 1


def lookup_repaired(dev: torch.device) -> int:
    """Positions the chunked lookup's repair pass has overwritten on
    ``dev`` since the process started (reads a device counter:
    synchronises)."""
    t = _REPAIRED.get(kernels._index(dev))
    return 0 if t is None else int(t.item())


def lookup_chunks_plain(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool = False,
                        cmod: bool = False, smod: bool = False,
                        entry: Optional[torch.Tensor] = None, C: int = kernels.TABLE_SCAN_C,
                        W: int = kernels.TABLE_SCAN_W) -> Tuple[torch.Tensor, int]:
    """The chunked lookup (S1, S2 of ``csrc/probe_dfa_wide.cu``) with torch
    ops, vectorised over chunks: the states of ``dfa_wide_plain`` and the
    positions S2 overwrote.  S1: chunks of ``C`` positions, each from the
    entry state ``W`` positions before it (from position 0 if that comes
    first: then exact), its guess g the state reached there, its end e;
    S2: chunk by chunk, where the true end before chunk c differs from
    g[c], it is walked again from that end, overwriting, until the walk
    meets the stored state or the chunk ends.  Guesses and ends compare as
    states clamped to S (every state past S steps to 0)."""
    K_, _W, S_, L_, TB_ = _check(tbl, chars, hilo, "lookup", entry)
    check_ranges(tbl, hilo)
    dev = chars.device
    rows = _classes(chars, K_, cmod) * (S_ + 1)  # [L, TB]
    flat = next_states(tbl, hilo, smod).reshape(-1)
    e0 = (torch.zeros(TB_, dtype=torch.int64, device=dev) if entry is None else entry.long())

    def step(s, p):  # the states after position p (a tensor of positions, or an int)
        return flat[rows[p] + torch.where((s >= 0) & (s < S_), s, S_)]

    def key(s):
        return torch.where((s >= 0) & (s < S_), s, S_)

    out = torch.empty((L_, TB_), dtype=torch.int64, device=dev)
    n_ch = -(-L_ // C)
    cs = torch.arange(n_ch, device=dev) * C
    ce = (cs + C).clamp(max=L_)
    ws = (cs - W).clamp(min=0)
    lead = cs - ws
    s = e0[None, :].expand(n_ch, -1).clone()
    g = key(s)
    for t in range(int((ce - ws).max())):  # S1, all chunks at once
        pos = ws + t
        g = torch.where((lead == t)[:, None], key(s), g)
        live = pos < ce
        s = torch.where(live[:, None], step(s, pos.clamp(max=L_ - 1)), s)
        keep = live & (pos >= cs)
        out[pos[keep]] = s[keep]
    e = key(s)
    repaired, end = 0, e[0]
    for c in range(1, n_ch):  # S2, chunk by chunk
        bad = end != g[c]
        s = end.clone()
        for p in range(int(cs[c]), int(ce[c])):
            if not bool(bad.any()):
                break
            s_new = step(s, p)
            bad = bad & (s_new != out[p])
            out[p] = torch.where(bad, s_new, out[p])
            repaired += int(bad.sum())
            s = torch.where(bad, s_new, s)
        end = torch.where(bad, key(s), e[c])
    return out.to(torch.int32), repaired


def dfa_wide_cuda(tbl: torch.Tensor, chars: torch.Tensor, hilo: bool = False,
                  cmod: bool = False, smod: bool = False,
                  entry: Optional[torch.Tensor] = None, form: str = "lookup",
                  frags: Optional[torch.Tensor] = None,
                  cw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The ``dfa_wide`` kernel in ``form``.  ``frags``: ``b_fragments(tbl)``
    for the product form (made here when not given); the lookup form's
    table in shared memory where it fits (``table_in_smem``), else in
    global memory, and its chunks ``cw`` = (C, W), ``(0, 0)`` for the
    serial form, ``None`` for ``lookup_form``'s choice (the chunked form
    is two launches).  Precondition (``check_ranges``; not checked here)."""
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
    C = Wu = 0
    if form == "lookup":
        C, Wu = lookup_form(TB_, L_, dev) if cw is None else cw
        if C < 0 or Wu < 0 or (C == 0 and Wu != 0):
            raise ValueError(f"cw {(C, Wu)}: expected (0, 0) or (C > 0, W >= 0)")
    elif cw is not None:
        raise ValueError(f"cw: the lookup form's alone, not {form!r}'s")
    smem = form == "lookup" and table_in_smem(K_, S_, dev)
    out = torch.empty((L_, TB_), dtype=torch.int32, device=dev)
    scratch = repaired = None
    if C:
        scratch = torch.empty((2, -(-L_ // C), TB_), dtype=torch.int32, device=dev)
        repaired = _REPAIRED.get(kernels._index(dev))
        if repaired is None:
            repaired = _REPAIRED[kernels._index(dev)] = torch.zeros(1, dtype=torch.int64,
                                                                   device=dev)
    lib = kernels.build_probes()
    with torch.cuda.device(dev):
        kernels._launch(kernels.DFA_WIDE, lib.h2r_dfa_wide, tbl.data_ptr(), kernels._ptr(frags),
                        chars.data_ptr(), entry.data_ptr(), out.data_ptr(),
                        kernels._ptr(scratch), kernels._ptr(repaired), TB_, L_, K_, W, int(hilo),
                        int(cmod), int(smod), FORMS.index(form), int(smem), C, Wu,
                        kernels._stream(chars), n=2 if C else 1)
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
    state, or for the product its flops at the probes' method (the one-hot
    [TB, K] times all W columns a step, tiles of 16 strings, 16 classes
    and 8 columns: what a dense product of that shape needs)."""
    work = dict(nbytes=2 * L_ * TB_ * 4 + K_ * W * 2 + TB_ * 4, int32_ops=L_ * TB_)
    if form == "onehot_mma":
        tiles = -(-TB_ // 16) * -(-K_ // 16) * -(-W // 8)
        work.update(mma_flops=2 * 16 * 16 * 8 * tiles * L_, mma_peak=BF16_PEAK)
    return work


def wide_line(timer, card, probe: str, tbl: torch.Tensor, chars: torch.Tensor, form: str,
              plain, hilo: bool = False, cmod: bool = False, smod: bool = False,
              entry: Optional[torch.Tensor] = None, **kw) -> Tuple[dict, torch.Tensor]:
    """A ``dfa_wide`` measurement (``harness.measure``; ns a step over L),
    the product's fragments made once beforehand; ``plain`` as measure's
    (one plain output shared by a probe's forms).  On the card a lookup
    line names its table's place and its form (``cw``: (C, W), or
    ``(0, 0)`` serial) and counts its launches (two chunked)."""
    K_, W = tbl.shape
    L_, TB_ = chars.shape
    frags = b_fragments(tbl) if form == "onehot_mma" and chars.is_cuda else None
    extra = {}
    if chars.is_cuda and form == "lookup":
        extra["table"] = "shared" if table_in_smem(K_, W // 2 if hilo else W,
                                                   chars.device) else "global"
        extra["cw"] = list(lookup_form(TB_, L_, chars.device))
        extra["calls"] = wide_launches(TB_, L_, form, chars.device)
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
    recs = [wide_line(timer, card, "configs3", tbl, cls, form, want, hilo=True, entry=entry)[0]
            for form in ("lookup", "onehot_mma")]
    # the lookup's repaired positions in one call, beside its twin's on the same input
    before = lookup_repaired(dev)
    dfa_wide(tbl, cls, hilo=True, entry=entry)
    recs[0]["repaired"] = lookup_repaired(dev) - before
    C, W = recs[0]["cw"]
    if C:
        twin, recs[0]["repaired_twin"] = lookup_chunks_plain(tbl, cls, hilo=True, entry=entry,
                                                             C=C, W=W)
        recs[0]["twin_max_abs_err"] = harness.max_abs_err(twin, want[0])
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
        S=nt.shape[1], form=f"b8 {'chunked' if form[0] else 'serial'}", cw=list(form))[0])
    before = kernels.table_scan_repaired(dev)
    b8()
    recs[-1]["repaired"] = kernels.table_scan_repaired(dev) - before
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
