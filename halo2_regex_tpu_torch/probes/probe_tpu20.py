"""tools/probe_tpu20.py's A, D and E on the H100: a serial bit-op scan,
swept over ops a step, at the bitplane scan's geometry; a product
accumulated over a grid axis; a state carried across chunks.

``bitop_scan(cls, st0, n_ops, sb=5, k=12, lc=128)``: per word (32
strings) and step i of L, ``n_ops`` and/or/xor ops on ``sb`` state planes
and a running ``acc``, op t reading plane ``t % sb`` and class plane
``t % k`` of step i:

- ``t % 3 == 0``: ``acc ^= plane & cls``;
- ``t % 3 == 1``: ``acc |= plane & ~cls``;
- ``t % 3 == 2``: ``plane = plane ^ acc`` (later ops of the step read it);

then ``out[i] = acc``.  The planes carry across all of L; ``acc`` restarts
from plane 0 at the first step of every chunk of ``lc`` steps (the probe's
fori_loop over a grid step starts from its scratch's plane 0).  The probe
starts from zero planes, which every op keeps at zero; here the start
planes ``st0`` [sb, NWS, 128] are an input (zeros reproduce the probe).

Layouts: cls [L, k, NWS, 128] int32, out [L, 1, NWS, 128] int32.  The
kernels (``csrc/probe_tpu20.cu``) are built for the probe's sweep: n_ops
in ``N_OPS``, sb = 5, k = 12.  Two forms (``form``), the same outputs:

- ``"table"``, the default: every op is bitwise, so each string (a bit of
  a word) is an automaton of its own, its state the sb planes and acc (6
  bits), its input the k class bits of a step.  ``bitop_table(n_ops)``
  builds T[state, class] -> next state once a device and n_ops (a launch
  of the ``bitop_table`` kernel; ``bitop_table_plain`` is its torch twin,
  ``table_words`` the kernel's packing), and the scan walks it, a lane a
  string, one shared-memory lookup a step whatever n_ops is: one launch a
  call once T is built.  ``bitop_scan_table_plain`` walks T string by
  string in torch;
- ``"serial"``: a thread a word runs the n_ops ops of every step (what a
  step of dependent LOP3s costs: chip_smoke's [10] sets K2 on this sweep).

D (``mm_kern`` :211) is probe_tpu21's D with block shapes that make it
raise: ``a_ref[0]`` is [1, 128, 128], so its ``jnp.dot`` gives [1, 128, 1,
128] and the store refuses it.  The port runs the corrected body,
:mod:`.probe_tpu21`'s ``mma_accum``, at the probe's [4, 2, 128, 128].

E (``kern2`` :246): ``bitop_carry(cls, st0, lc, steps)``: per string
group b and word w, ``st ^= cls[b, j * lc + i] & st`` for i < ``steps`` at
each chunk j of ``lc`` positions, st carried across the chunks from
``st0`` [1, NWS, 128], out [NB, 1, 1, NWS, 128] the last st.  The probe as
written reads one position a chunk (its loop runs ``cls_ref.shape[0]`` =
1 trip: ``steps=1``) from its zeroed scratch, so every output is zero;
``steps=lc`` is the carry scan it meant.  cls [NB, L, 1, NWS, 128] int32.
Its kernel is ``bitop_scan``'s carry mode (``bitop_carry``, the same
source).  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu20 --sections ADE

(``--sections`` picks the sections, A alone by default; ``--device cpu``
runs the plain versions at L=256, NWS=1, n_ops 96).  A's lines: per n_ops
the table's build (``bitop_table``), then both forms on one plain output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu21 import SHAPE as D_SHAPE
from .probe_tpu21 import accum_line
from .probe_tpu21 import inputs as d_inputs

L, NWS, LANE = 1024, 8, 128  # the probe's shape: 8 x 128 words, B = 32768 strings
N_OPS = (96, 192, 384, 768)  # the probe's sweep, the kernel's instances
SB, K, LC = 5, 12, 128
FORMS = ("table", "serial")
# T's packing (csrc/probe_tpu20.cu kTabPerWord, kTabRowWords): five 6-bit
# entries a 32-bit word, 820 words a state row, 64 rows
TABLE_PER_WORD = 5
TABLE_ROW_WORDS = -(-(1 << K) // TABLE_PER_WORD)
TABLE_WORDS = (1 << (SB + 1)) * TABLE_ROW_WORDS
# a diagnostic, not a bound: the table kernel's own int32 instructions a
# string (lane) and 8 steps (96 class bits, 3 transposed words): the
# transposes' 15 funnel shifts and 15 LOP3s (30), each step's index (its
# 12 bits 2, the product 1, T's word 3, the shift 2: 64), the chain's
# IMAD, shift and mask (24), the ballot's predicate (16).  Its LDS, SHFL
# and VOTE run on the shared-memory pipe.
TABLE_OPS_8_STEPS = 134
_TABLES: Dict[Tuple[int, int], torch.Tensor] = {}


def bitop_form(form: Optional[str]) -> str:
    """The form a call runs: ``form``, or ``"table"`` where it is None;
    raises on an unknown form."""
    if form is None:
        return "table"
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    return form


def _check(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int, k: int, lc: int) -> int:
    """Shapes and dtypes; returns L."""
    if cls.dim() != 4 or cls.shape[1] != k or cls.shape[3] != LANE or cls.dtype != torch.int32:
        raise ValueError(f"cls: expected [L, k={k}, NWS, {LANE}] int32, got "
                         f"{cls.dtype}{tuple(cls.shape)}")
    if tuple(st0.shape) != (sb, cls.shape[2], LANE) or st0.dtype != torch.int32:
        raise ValueError(f"st0: expected [sb={sb}, {cls.shape[2]}, {LANE}] int32, got "
                         f"{st0.dtype}{tuple(st0.shape)}")
    if n_ops < 1 or lc < 1:
        raise ValueError(f"n_ops {n_ops} and lc {lc} must be positive")
    return cls.shape[0]


def bitop_scan_plain(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB,
                     k: int = K, lc: int = LC) -> torch.Tensor:
    """The probe's A op by op, every word at once: one torch op (two for
    the ANDs) an op a step."""
    L_ = _check(cls, st0, n_ops, sb, k, lc)
    planes = list(st0.unbind(0))
    ncls = ~cls
    outs = []
    acc = planes[0]
    for i in range(L_):
        if i % lc == 0:
            acc = planes[0]
        cw, nw = cls[i].unbind(0), ncls[i].unbind(0)
        for t in range(n_ops):
            a = planes[t % sb]
            if t % 3 == 0:
                acc = acc ^ (a & cw[t % k])
            elif t % 3 == 1:
                acc = acc | (a & nw[t % k])
            else:
                planes[t % sb] = a ^ acc
        outs.append(acc)
    return torch.stack(outs)[:, None]


def bitop_table_plain(n_ops: int, sb: int = SB, k: int = K) -> torch.Tensor:
    """T [2^(sb + 1), 2^k] int32: T[st, c] is the state after one step of
    the n_ops ops from state st (plane j in bit j, acc in bit sb) on the
    class bits c (class plane j in bit j), every entry at once as a 0/1
    tensor."""
    e = torch.arange(1 << (sb + 1 + k), dtype=torch.int32)
    cw = [(e >> c) & 1 for c in range(k)]
    planes = [(e >> (k + j)) & 1 for j in range(sb)]
    acc = (e >> (k + sb)) & 1
    for t in range(n_ops):
        a, c = planes[t % sb], cw[t % k]
        if t % 3 == 0:
            acc = acc ^ (a & c)
        elif t % 3 == 1:
            acc = acc | (a & (1 - c))
        else:
            planes[t % sb] = a ^ acc
    st = acc << sb
    for j in range(sb):
        st = st | (planes[j] << j)
    return st.reshape(1 << (sb + 1), 1 << k)


def table_words(T: torch.Tensor) -> torch.Tensor:
    """T [64, 4096] in the kernel's packing: ``TABLE_WORDS`` int32, row st
    at word st * ``TABLE_ROW_WORDS``, entry c in bits 6 (c % 5) of the
    row's word c // 5."""
    if tuple(T.shape) != (1 << (SB + 1), 1 << K):
        raise ValueError(f"T: expected [{1 << (SB + 1)}, {1 << K}], got {tuple(T.shape)}")
    pad = torch.zeros((T.shape[0], TABLE_ROW_WORDS * TABLE_PER_WORD), dtype=torch.int64,
                      device=T.device)
    pad[:, :T.shape[1]] = T
    shifts = 6 * torch.arange(TABLE_PER_WORD, device=T.device)
    words = (pad.reshape(T.shape[0], TABLE_ROW_WORDS, TABLE_PER_WORD) << shifts).sum(-1)
    return words.reshape(-1).to(torch.int32)


def bitop_table_cuda(n_ops: int, dev: torch.device) -> torch.Tensor:
    """A new T for n_ops on ``dev`` by the ``bitop_table`` kernel, packed as
    ``table_words``."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        raise ValueError(f"bitop_table_cuda: expected a CUDA device, got {dev}")
    if n_ops not in N_OPS:
        raise ValueError(f"the table kernel is built for n_ops in {N_OPS}; got {n_ops}")
    tab = torch.empty(TABLE_WORDS, dtype=torch.int32, device=dev)
    lib = kernels.build_probes()
    with torch.cuda.device(dev):
        kernels._launch(kernels.BITOP_TABLE, lib.h2r_bitop_table, tab.data_ptr(), n_ops,
                        kernels._stream(tab))
    return tab


def bitop_table(n_ops: int, dev: torch.device) -> torch.Tensor:
    """T for n_ops on ``dev``: built at the first call (one launch), then
    the same tensor (it depends on the circuit alone, never on the data)."""
    key = (kernels._index(dev), n_ops)
    tab = _TABLES.get(key)
    if tab is None:
        tab = _TABLES[key] = bitop_table_cuda(n_ops, torch.device("cuda", key[0]))
    return tab


def _restart(st: torch.Tensor, sb: int) -> torch.Tensor:
    """A state at the first step of a chunk: acc starts again from plane 0."""
    return (st & ((1 << sb) - 1)) | ((st & 1) << sb)


def bitop_scan_table_plain(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB,
                           k: int = K, lc: int = LC,
                           table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The table form string by string: each string's state (its bit of
    the sb start planes; acc set at step 0) walks ``table`` (default
    ``bitop_table_plain(n_ops, sb, k)``) at its k class bits a step, acc
    restarting every ``lc`` steps; out[i] holds each string's acc bit."""
    L_ = _check(cls, st0, n_ops, sb, k, lc)
    T = (bitop_table_plain(n_ops, sb, k) if table is None else table).to(cls.device).reshape(-1)
    bit = torch.arange(32, dtype=torch.int32, device=cls.device)
    words = cls.reshape(L_, k, -1)  # [L, k, NW]
    idx = torch.zeros((L_, words.shape[2], 32), dtype=torch.int64, device=cls.device)
    for c in range(k):
        idx |= (((words[:, c, :, None] >> bit) & 1) << c).to(torch.int64)
    st = torch.zeros((words.shape[2], 32), dtype=torch.int64, device=cls.device)
    for j in range(sb):
        st |= (((st0[j].reshape(-1, 1) >> bit) & 1) << j).to(torch.int64)
    weight = torch.ones(32, dtype=torch.int64, device=cls.device) << bit.to(torch.int64)
    outs = []
    for i in range(L_):
        if i % lc == 0:
            st = _restart(st, sb)
        st = T[(st << k) | idx[i]].to(torch.int64)
        outs.append((((st >> sb) & 1) * weight).sum(-1))
    out = torch.stack(outs) if outs else torch.zeros((0, words.shape[2]), dtype=torch.int64)
    out = (out + 2**31) % 2**32 - 2**31  # bit 31 as int32's sign
    return out.to(torch.int32).reshape(L_, 1, *cls.shape[2:])


def bitop_scan_cuda(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB, k: int = K,
                    lc: int = LC, form: Optional[str] = None) -> torch.Tensor:
    """The ``bitop_scan`` kernel in ``form`` (``bitop_form``): n_ops in
    ``N_OPS``, sb = 5 and k = 12 (compile-time constants of both forms);
    any L and lc.  The table form builds T at its first call for n_ops on
    this device (a ``bitop_table`` launch), then launches the scan alone."""
    form = bitop_form(form)
    L_ = _check(cls, st0, n_ops, sb, k, lc)
    if n_ops not in N_OPS or (sb, k) != (SB, K):
        raise ValueError(f"the kernel is built for n_ops in {N_OPS}, sb={SB}, k={K}; got "
                         f"n_ops={n_ops}, sb={sb}, k={k}")
    nws = cls.shape[2]
    kernels._check(cls, "cls", torch.int32, (L_, k, nws, LANE))
    kernels._check(st0, "st0", torch.int32, (sb, nws, LANE))
    out = torch.empty((L_, 1, nws, LANE), dtype=torch.int32, device=cls.device)
    lib = kernels.build_probes()
    tab = bitop_table(n_ops, cls.device).data_ptr() if form == "table" else None
    kernels._launch(kernels.BITOP_SCAN, lib.h2r_bitop_scan, cls.data_ptr(), st0.data_ptr(), tab,
                    out.data_ptr(), n_ops, nws * LANE, L_, lc, kernels._stream(cls))
    return out


def bitop_scan(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB, k: int = K,
               lc: int = LC, form: Optional[str] = None) -> torch.Tensor:
    """The kernel on CUDA tensors (``form`` as ``bitop_scan_cuda``'s), the
    plain version on CPU ones."""
    bitop_form(form)
    if cls.device.type == "cpu":
        return bitop_scan_plain(cls, st0, n_ops, sb, k, lc)
    return bitop_scan_cuda(cls, st0, n_ops, sb, k, lc, form)


def inputs(L_: int, nws: int, seed: int = 0, dev: Optional[torch.device] = None):
    """Seeded class planes [L, K, NWS, 128] (as the probe's: 31 random
    bits a word) and start planes [SB, NWS, 128] over the whole range
    (the probe's are zero, and so is then its output)."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2**31, size=(L_, K, nws, LANE)).astype(np.int32)
    st0 = rng.integers(-(2**31), 2**31, size=(SB, nws, LANE), dtype=np.int64).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (cls, st0))


def scan_work(form: str, L_: int, nws: int, n_ops: int) -> Dict[str, int]:
    """The bytes and int32 ops a bound reads for one call in ``form``: the
    classes and start planes read once and the output written once; the
    serial form's n_ops LOP3s a word and step; the table form's one lookup
    a string and step (what the function needs of it, not the kernel's
    own instructions: those are ``TABLE_OPS_8_STEPS``, a diagnostic)."""
    nbytes = (L_ * K * nws * LANE + SB * nws * LANE + L_ * nws * LANE) * 4
    if form == "serial":
        return dict(nbytes=nbytes, int32_ops=n_ops * L_ * nws * LANE)
    return dict(nbytes=nbytes, int32_ops=L_ * 32 * nws * LANE)


def run(dev: torch.device, L_: int = L, nws: int = NWS,
        n_ops: Sequence[int] = N_OPS) -> List[dict]:
    """The sweep at [L, K, NWS, 128], a value of n_ops at a time: the table
    build (``bitop_table_cuda`` against ``table_words(bitop_table_plain)``),
    then the table form and the serial form, each held to one plain output
    (``harness.measure``; the table built before its form is measured, so a
    call launches the scan alone); a line each, the forms' with the share
    of output words that are not zero, the table form's on the card with
    its kernel's int32 instructions a string and step (a diagnostic)."""
    cls, st0 = inputs(L_, nws, dev=dev)
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for n in n_ops:
        if dev.type == "cuda":
            recs.append(harness.measure(
                timer, card, "A_bitop_table", kernels.BITOP_TABLE,
                lambda: bitop_table_cuda(n, dev), 1,
                lambda: table_words(bitop_table_plain(n)).to(dev),
                nbytes=TABLE_WORDS * 4, int32_ops=n * (1 << (SB + 1 + K)) // 32, n_ops=n,
                shape=[1 << (SB + 1), 1 << K])[0])
            bitop_table(n, dev)
            tp = timer(lambda: bitop_scan_plain(cls, st0, n), 0, 1)
            plain = (tp["out"], tp["median"])
        else:
            plain = lambda: bitop_scan_plain(cls, st0, n)  # noqa: E731
        for form in FORMS:
            rec, out = harness.measure(
                timer, card, "A_bitop_scan", kernels.BITOP_SCAN,
                lambda: bitop_scan(cls, st0, n, form=form), L_, plain,
                **scan_work(form, L_, nws, n), n_ops=n, form=form, shape=[L_, K, nws, LANE],
                strings=32 * nws * LANE)
            rec["nonzero_share"] = float((out != 0).float().mean())
            if dev.type == "cuda" and form == "table":  # the diagnostic
                rec["kernel_int32_a_step"] = TABLE_OPS_8_STEPS / 8
            recs.append(rec)
            if dev.type != "cuda":
                break  # the plain version once: both forms are the same function
    return recs


# ------------------------------------------------------------ E: bitop_carry

E_NB = 2  # E's string groups (its grid's first axis)


def _check_carry(cls: torch.Tensor, st0: torch.Tensor, lc: int, steps: int
                 ) -> Tuple[int, int, int]:
    """Shapes and dtypes; returns (NB, L, NWS)."""
    if (cls.dim() != 5 or cls.shape[2] != 1 or cls.shape[4] != LANE or cls.dtype != torch.int32
            or 0 in cls.shape):
        raise ValueError(f"cls: expected [NB, L, 1, NWS, {LANE}] int32, got "
                         f"{cls.dtype}{tuple(cls.shape)}")
    NB, L_, _one, nws, _lane = cls.shape
    if tuple(st0.shape) != (1, nws, LANE) or st0.dtype != torch.int32:
        raise ValueError(f"st0: expected [1, {nws}, {LANE}] int32, got "
                         f"{st0.dtype}{tuple(st0.shape)}")
    if lc < 1 or L_ % lc or not 1 <= steps <= lc:
        raise ValueError(f"lc {lc} must divide L = {L_}, and steps {steps} lie in [1, lc]")
    return NB, L_, nws


def bitop_carry_plain(cls: torch.Tensor, st0: torch.Tensor, lc: int = LC,
                      steps: int = 1) -> torch.Tensor:
    """E's recurrence, every string group and word at once: a torch op a
    position read."""
    NB, L_, nws = _check_carry(cls, st0, lc, steps)
    st = st0[0].expand(NB, nws, LANE)
    for j in range(L_ // lc):
        for i in range(steps):
            st = st ^ (cls[:, j * lc + i, 0] & st)
    return st.reshape(NB, 1, 1, nws, LANE).contiguous()


def bitop_carry_cuda(cls: torch.Tensor, st0: torch.Tensor, lc: int = LC,
                     steps: int = 1) -> torch.Tensor:
    """The ``bitop_carry`` kernel: a thread a (b, word)."""
    NB, L_, nws = _check_carry(cls, st0, lc, steps)
    kernels._check(cls, "cls", torch.int32, (NB, L_, 1, nws, LANE))
    kernels._check(st0, "st0", torch.int32, (1, nws, LANE))
    out = torch.empty((NB, 1, 1, nws, LANE), dtype=torch.int32, device=cls.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.BITOP_CARRY, lib.h2r_bitop_carry, cls.data_ptr(), st0.data_ptr(),
                    out.data_ptr(), NB, nws * LANE, L_, lc, steps, kernels._stream(cls))
    return out


def bitop_carry(cls: torch.Tensor, st0: torch.Tensor, lc: int = LC,
                steps: int = 1) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if cls.device.type == "cpu":
        return bitop_carry_plain(cls, st0, lc, steps)
    return bitop_carry_cuda(cls, st0, lc, steps)


def carry_inputs(L_: int, nws: int, seed: int = 0, dev: Optional[torch.device] = None):
    """E's classes [E_NB, L, 1, NWS, 128] (31 random bits a word, as the
    probe's) and a start [1, NWS, 128] over the whole int32 range."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2**31, size=(E_NB, L_, 1, nws, LANE)).astype(np.int32)
    st0 = rng.integers(-(2**31), 2**31, size=(1, nws, LANE), dtype=np.int64).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (cls, st0))


def run_de(dev: torch.device, L_: int = L, nws: int = NWS, lc: int = LC) -> List[dict]:
    """D (``mma_accum`` at the probe's [4, 2, 128, 128], its all-ones
    inputs) and E (``bitop_carry`` at [2, L, 1, NWS, 128]: one position a
    chunk from the zero start, as written; from a seeded start; every
    position, ``steps = lc``): a line each (``harness.measure``).  E's
    lines carry the share of output words that are not zero."""
    timer, card = harness.Timer(dev), harness.card(dev)
    a, b = d_inputs(D_SHAPE, "ones", dev=dev)
    recs = [accum_line(timer, card, "D_mxu_2dgrid_scratch", a, b, "ones")]
    cls, st0 = carry_inputs(L_, nws, dev=dev)
    zero = torch.zeros_like(st0)
    for start, s0, steps in (("zero", zero, 1), ("seeded", st0, 1), ("seeded", st0, lc)):
        n_pos = L_ // lc * steps
        rec, out = harness.measure(
            timer, card, "E_2dgrid_bitops_scratch", kernels.BITOP_CARRY,
            lambda: bitop_carry(cls, s0, lc, steps), n_pos,
            lambda: bitop_carry_plain(cls, s0, lc, steps),
            nbytes=(E_NB * n_pos * nws * LANE + s0.numel() + E_NB * nws * LANE) * 4,
            int32_ops=E_NB * n_pos * nws * LANE, shape=list(cls.shape), lc=lc, reads=steps,
            start=start)
        rec["nonzero_share"] = float((out != 0).float().mean())
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu20.py's A: the serial bit-op scan, n_ops "
                       f"{', '.join(map(str, N_OPS))} at [{L}, {K}, {NWS}, {LANE}] (the CPU: "
                       f"96 at [256, {K}, 1, {LANE}]); D: mma_accum at [4, 2, 128, 128]; E: "
                       f"bitop_carry at [2, {L}, 1, {NWS}, {LANE}] (the CPU: [2, 256, 1, 1, "
                       f"{LANE}], chunks of 64)")
    p.add_argument("--sections", default="A",
                   help="the sections to run, any of A, D and E (default: A)")
    a = p.parse_args(argv)
    if not a.sections or set(a.sections) - set("ADE"):
        p.error(f"--sections {a.sections!r}: expected letters of ADE")
    dev = harness.device(a.device)
    cpu = dev.type == "cpu"
    recs = []
    if "A" in a.sections:
        recs += run(dev, 256, 1, (96,)) if cpu else run(dev)
    if "D" in a.sections or "E" in a.sections:
        recs += [r for r in (run_de(dev, 256, 1, 64) if cpu else run_de(dev))
                 if r["probe"][0] in a.sections]
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
