"""The marker-stream (Parabix-style) matcher of tools/probe_tpu57_lib.py,
without JAX, and its H100 kernel ``marker_match``.

It gives the verdict of the restricted from-header form

    (?:\\A|\\r\\n) "from:" [A-Za-z0-9.\\-]+ "@" [A-Za-z0-9.\\-]+ "\\r\\n" \\Z

as bitstream operations on the packed planes, with no DFA: byte-class
streams from the 8 byte-bit planes (a shared Shannon BDD, ``CLASS_PROG``),
the literal ``from:`` by a shift-AND cascade gated on line starts, NAME+
and DOM+ by two affine span scans ``x' = a & x | b``, and the end anchor
by the end plane.  The input is one stack [10, L, NW] int32: the 8
byte-bit planes, the enable plane and the end plane (bit set at each
string's last enabled position), in ``ops.bitplane.pack_bytes`` /
``pack_bool``'s mapping (bit 8s + m of word w is string 4*(w + NW*m) + s);
the verdict is one word per input word, in the same mapping.

- ``marker_match_plain``: the lib's ``marker_match`` (:66): log-step
  affine scans, a straight OR over positions;
- ``marker_match_reduced_plain``: the lib's ``marker_match_reduced``
  (:133), the body of both TPU kernels (tools/probe_tpu57.py:190,
  tools/probe_tpu61.py:228): the same with a tree OR;
- ``marker_chunks_plain``: the torch twin of the kernel's chunked form
  (its halo, its walk, and its composition of chunk summaries in the
  kernel's order: ``geometry``'s blocks, each folding its chunks, then the
  cluster folding its blocks);
- ``marker_match``: the kernel on a CUDA stack, the plain versions on a
  CPU one.

The kernel (``csrc/probe_marker.cu``) walks the positions left to right.
Written in terms of v = ds | at_ok, the program carries two affine
registers across positions: ns[i] = name[i] & (ns[i-1] | from_end[i]) and
v[i] = dom[i] & v[i-1] | at[i] & ns[i-1]; then ds[i] = dom[i] & v[i-1]
and done[i] = ds[i-2] & cr[i-1] & lf[i] & end[i].  Everything else reaches
back at most 7 positions (the cascade and the line start), so a chunk of
positions [s, e] reads those 7 before it again (its halo).  A chunk's
walk is AND/OR-linear in its two unknown carry-ins ns[s-1] and v[s-1]
(no term holds both), so one walk forms its summary as masks: ns and v at
e, and the OR of done over the positions whose ds it owns (it reads 2
positions past e for done[e+1], done[e+2]), each as a constant and a
coefficient of each carry-in.  Summaries compose in order (``compose``),
and the whole string's verdict is the composition's constant OR.  The
chunked kernel splits each word group's chunks over a cluster of blocks
(``geometry``): a block folds its chunks' summaries left to right, and
the cluster's first block folds the blocks' left to right.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.bitslice import Builder, Program, byte_set_expr, linearize
from ..ops import kernels
from ..ops.bitplane import pack_bool, pack_bytes

NAME_BYTES = [ord(c) for c in
              "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "0123456789.-"]
DOM_BYTES = NAME_BYTES

PY_PATTERN = (
    rb"(?:\A|\r\n)from:[A-Za-z0-9.\-]+@[A-Za-z0-9.\-]+\r\n\Z"
)

PLANES = 10  # the 8 byte-bit planes, enable, end
HALO = 7  # positions before a chunk that its cascade and line start read
AHEAD = 2  # positions after a chunk whose done terms read its ds
CHUNKS = (8, 16, 32, 64)  # the chunk lengths csrc/probe_marker.cu is built for
CHUNK = 16  # the default: the fastest at B = 32768 x L = 1024 on an H100 (PERF.md §6, P19)
# the chunked kernel's geometry (csrc/probe_marker.cu: kSpan, kMaxCluster)
SPAN = 64  # positions a block's round walks at most (its warps' chunks)
MAX_CLUSTER = 16  # blocks a cluster splits a word group's L over
CLASS_HEADER = "probe_marker_class.cuh"  # CLASS_PROG as C, written by class_header()


def build_class_prog() -> Program:
    """Straight-line program: byte_bit{0..7} planes -> class planes for
    f r o m : @ \\r \\n NAME DOM."""
    b = Builder()
    outs = {}
    for name, byts in (
        ("f", [ord("f")]),
        ("r", [ord("r")]),
        ("o", [ord("o")]),
        ("m", [ord("m")]),
        ("colon", [ord(":")]),
        ("at", [ord("@")]),
        ("cr", [13]),
        ("lf", [10]),
        ("name", NAME_BYTES),
        ("dom", DOM_BYTES),
    ):
        outs[name] = byte_set_expr(b, byts)
    return linearize(b, outs)


CLASS_PROG = build_class_prog()
# int32 ops a word and position of the serial walk: the class program, the
# enable ANDs of its distinct outputs and the 15 ops of the marker program
OPS_A_POSITION = CLASS_PROG.n_ops + len(set(CLASS_PROG.outputs.values())) + 15


def class_header() -> str:
    """``CLASS_PROG`` as the C header the kernel includes
    (``Program.to_c``): ``marker_classes(p, c)`` sets the class words of
    one position from its 8 byte-bit words."""
    names = list(CLASS_PROG.outputs)
    body = CLASS_PROG.to_c({f"byte_bit{j}": f"p[{j}]" for j in range(8)},
                           {n: f"c.{n}" for n in names})
    return "\n".join(
        ["// The class program of halo2_regex_tpu_torch/probes/probe_tpu57_lib.py",
         "// (CLASS_PROG, Program.to_c), written by its class_header(); a test holds",
         "// this file to it.  Do not edit by hand.",
         "#pragma once", "", "#include <cstdint>", "",
         "struct MarkerClasses {", f"  uint32_t {', '.join(names)};", "};", "",
         f"// {CLASS_PROG.n_ops} ops over {CLASS_PROG.n_regs} registers",
         "__device__ __forceinline__ void marker_classes(const uint32_t* p, "
         "MarkerClasses& c) {"]
        + [f"  {ln}" for ln in body] + ["}", ""])


# ------------------------------------------------------------ plain versions


def _classes(stack: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The class planes of every position, ANDed with the enable plane."""
    cls = CLASS_PROG.run({f"byte_bit{j}": stack[j] for j in range(8)})
    return {k: v & stack[8] for k, v in cls.items()}


def _shift_down(p: torch.Tensor, n: int = 1) -> torch.Tensor:
    """p[i] := p[i - n], zeros in front."""
    return torch.cat([p.new_zeros((n,) + p.shape[1:]), p[: p.shape[0] - n]])


def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of x' = a & x | b along axis 0 (log2 rounds)."""
    L = a.shape[0]
    shift = 1
    while shift < L:
        a_prev = torch.cat([a.new_full((shift,) + a.shape[1:], -1), a[: L - shift]])
        b_prev = torch.cat([b.new_zeros((shift,) + b.shape[1:]), b[: L - shift]])
        a, b = a_prev & a, (a & b_prev) | b
        shift *= 2
    return b


def _done(stack: torch.Tensor) -> torch.Tensor:
    """The lib's marker program up to ``done`` [L, NW]: a set bit where a
    string's last two bytes close a restricted from: line."""
    c = _classes(stack)
    first = torch.zeros_like(stack[8])
    first[0] = -1
    linestart = first | (_shift_down(c["cr"], 2) & _shift_down(c["lf"], 1))
    k = linestart & c["f"]
    for nm in ("r", "o", "m", "colon"):
        k = _shift_down(k) & c[nm]
    from_end = _shift_down(k)
    ns = _affine_scan(c["name"], from_end & c["name"])
    at_ok = c["at"] & _shift_down(ns)
    ds = _affine_scan(c["dom"], _shift_down(at_ok) & c["dom"])
    tail = _shift_down(ds, 1) & c["cr"]
    return _shift_down(tail, 1) & c["lf"] & stack[9]


def marker_match_plain(stack: torch.Tensor) -> torch.Tensor:
    """The lib's ``marker_match`` (tools/probe_tpu57_lib.py:66): the
    verdict [NW] int32, a straight OR over positions."""
    _check(stack, None)
    done = _done(stack)
    out = done[0]
    for i in range(1, done.shape[0]):
        out = out | done[i]
    return out


def marker_match_reduced_plain(stack: torch.Tensor) -> torch.Tensor:
    """The lib's ``marker_match_reduced`` (:133), the TPU kernels' body: the
    same verdict by a tree OR over positions (an odd count keeps its last
    row for the next round)."""
    _check(stack, None)
    x = _done(stack)
    n = x.shape[0]
    while n > 1:
        half = n // 2
        y = x[:half] | x[half: 2 * half]
        x = y if n % 2 == 0 else torch.cat([y, x[2 * half:]])
        n = x.shape[0]
    return x[0]


SUMMARY = ("na", "nb", "vv", "vn", "v0", "o0", "on", "ov")


def compose(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The summary of chunk a then chunk b, each in ``SUMMARY``'s order:
    ns_out = na & ns | nb; v_out = vv & v | vn & ns | v0; the OR of done =
    o0 | on & ns | ov & v (ns, v: the carry-ins)."""
    na, nb, vv, vn, v0, o0, on, ov = a
    Na, Nb, Vv, Vn, V0, O0, On, Ov = b
    return (Na & na, (Na & nb) | Nb, Vv & vv, (Vv & vn) | (Vn & na),
            (Vv & v0) | (Vn & nb) | V0, o0 | O0 | (On & nb) | (Ov & v0),
            on | (On & na) | (Ov & vn), ov | (Ov & vv))


IDENTITY = (-1, 0, -1, 0, 0, 0, 0, 0)  # the summary of no positions, in SUMMARY's order


def geometry(L: int, chunk: int) -> Tuple[int, int, int]:
    """The chunked kernel's split of a word group's L / chunk chunks
    (``geometry()`` of csrc/probe_marker.cu): K blocks a cluster (the
    largest divisor of the chunk count up to ``MAX_CLUSTER``), NB
    consecutive chunks a block, W warps a block (the largest divisor of NB
    with W x chunk <= ``SPAN``; NB / W rounds)."""
    nch = L // chunk
    K = max(k for k in range(1, min(nch, MAX_CLUSTER) + 1) if nch % k == 0)
    NB = nch // K
    W = max(w for w in range(1, max(1, min(NB, SPAN // chunk)) + 1) if NB % w == 0)
    return K, NB, W


def fold(summaries: Sequence[Tuple[torch.Tensor, ...]]) -> Tuple[torch.Tensor, ...]:
    """``summaries`` composed left to right from the identity."""
    ref = summaries[0][0]
    acc = tuple(torch.full_like(ref, v) for v in IDENTITY)
    for s in summaries:
        acc = compose(acc, s)
    return acc


def chunk_summaries(stack: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, ...]:
    """Each chunk's summary, SUMMARY's fields [L / chunk, NW] each: the
    chunk walks its halo (the ``HALO`` positions before it, zeros before
    position 0), its own positions and the ``AHEAD`` after it (zeros past
    L), all chunks at once."""
    L, NW = _check(stack, chunk)
    C = chunk
    NCH = L // C
    W = HALO + C + AHEAD
    c = _classes(stack)
    c["end"] = stack[9]

    def win(p: torch.Tensor) -> torch.Tensor:  # [NCH, W, NW]: chunk k's s - HALO .. e + AHEAD
        q = torch.cat([p.new_zeros((HALO, NW)), p, p.new_zeros((AHEAD, NW))])
        return q.unfold(0, W, C).permute(0, 2, 1)

    w = {k: win(v) for k, v in c.items()}
    gpos = (torch.arange(NCH) * C - HALO)[:, None]  # chunk k's first window position
    z = stack.new_zeros((NCH, NW))
    ones = stack.new_full((NCH, NW), -1)
    cr1 = cr2 = lf1 = z
    k0 = k1 = k2 = k3 = k4 = z
    ns0, nsN, v0, vN, vV = z, ones, z, z, ones
    d1 = d2 = (z, z, z)  # ds at i - 1, i - 2: (constant, ns coefficient, v coefficient)
    o = [z, z, z]
    for r in range(W):
        x = {k: v[:, r] for k, v in w.items()}
        first = torch.where(gpos + r == 0, -1, 0).to(stack.dtype).to(stack.device)
        if r >= HALO:  # done[i] = ds[i-2] & cr[i-1] & lf[i] & end[i]
            t = cr1 & x["lf"] & x["end"]
            o = [o[j] | (d2[j] & t) for j in range(3)]
        if HALO <= r < HALO + C:
            nd = (x["dom"] & v0, x["dom"] & vN, x["dom"] & vV)
            v0, vN, vV = nd[0] | (x["at"] & ns0), nd[1] | (x["at"] & nsN), nd[2]
            ns0, nsN = x["name"] & (ns0 | k4), x["name"] & nsN
            d2, d1 = d1, nd
        elif r >= HALO + C:
            d2, d1 = d1, (z, z, z)
        ls = first | (cr2 & lf1)
        k0, k1, k2, k3, k4 = ls & x["f"], k0 & x["r"], k1 & x["o"], k2 & x["m"], k3 & x["colon"]
        cr2, cr1, lf1 = cr1, x["cr"], x["lf"]
    return (nsN, ns0, vV, vN, v0, *o)


def marker_chunks_plain(stack: torch.Tensor, chunk: int) -> torch.Tensor:
    """The kernel's chunked form in torch ops: the chunk summaries
    (``chunk_summaries``), each block of ``geometry`` folding its NB
    chunks in order, then the cluster's K block summaries folded in order;
    the verdict is the constant OR.  ``chunk`` = L is the serial form's
    walk (one chunk).  The verdict [NW] int32."""
    L, _ = _check(stack, chunk)
    s = chunk_summaries(stack, chunk)
    K, NB, _ = geometry(L, chunk)
    blocks = [fold([tuple(f[k] for f in s) for k in range(r * NB, (r + 1) * NB)])
              for r in range(K)]
    return fold(blocks)[5]


# ----------------------------------------------------------------- the kernel


def _check(stack: torch.Tensor, chunk: Optional[int]) -> Tuple[int, int]:
    """L and NW; raises on a stack or chunk the kernel does not take."""
    if stack.dtype != torch.int32 or stack.dim() != 3 or stack.shape[0] != PLANES:
        raise ValueError(f"stack: expected [{PLANES}, L, NW] int32, got "
                         f"{stack.dtype}{tuple(stack.shape)}")
    _, L, NW = stack.shape
    if L < 1 or NW < 32 or NW % 32:
        raise ValueError(f"stack {tuple(stack.shape)}: expected L >= 1 and NW a positive "
                         "multiple of 32")
    if chunk is not None and (chunk < 1 or L % chunk):
        raise ValueError(f"chunk {chunk}: expected a divisor of L={L}")
    return L, NW


def marker_match_cuda(stack: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The ``marker_match`` kernel: ``chunk`` = L the serial form (a thread
    a word walks every position, the planes through a ``cp.async`` ring),
    else the chunked form (a warp a word group and chunk, ``chunk`` one of
    ``CHUNKS``; the stack read by TMA, so 16-byte aligned).  One launch."""
    L, NW = _check(stack, chunk)
    if chunk != L and chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk}: the kernel is built for {CHUNKS} and the serial "
                         f"form (chunk = L = {L})")
    kernels._check(stack, "stack", torch.int32, (PLANES, L, NW))
    kernels._check_aligned(stack, "stack", 4 if chunk == L else 16)
    out = torch.empty((NW,), dtype=torch.int32, device=stack.device)
    kernels._launch(kernels.MARKER_MATCH, kernels.build_probes().h2r_marker_match,
                    stack.data_ptr(), out.data_ptr(), NW, L, 0 if chunk == L else chunk,
                    kernels._stream(stack))
    return out


def marker_match(stack: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The verdict [NW] int32: the kernel on a CUDA stack (``chunk`` = L
    the serial form), the plain versions on a CPU one (the reduced form
    for the serial walk, the chunked twin for a chunk)."""
    if stack.device.type == "cpu":
        L, _ = _check(stack, chunk)
        if chunk == L:
            return marker_match_reduced_plain(stack)
        return marker_chunks_plain(stack, chunk)
    return marker_match_cuda(stack, chunk)


# ------------------------------------------------------------------ the inputs


def marker_stack(chars: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] uint8 chars and [B] lengths (B a multiple of 32) -> the
    stack [10, L, B/32] int32 the probes build (tools/probe_tpu57.py:
    169-177): ``pack_bytes``' planes, the enable plane and the end plane."""
    B, L = chars.shape
    pos = torch.arange(L, device=chars.device)
    en = pos[None, :] < lengths.to(chars.device)[:, None]
    en_next = torch.cat([en[:, 1:], torch.zeros_like(en[:, :1])], 1)
    return torch.stack(pack_bytes(chars, L) + [pack_bool(en, L), pack_bool(en & ~en_next, L)])


def expected(chars: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Python ``re``'s verdict of ``PY_PATTERN`` on each string [B] bool."""
    return np.array([re.search(PY_PATTERN, bytes(chars[i, : lengths[i]]), re.DOTALL) is not None
                     for i in range(chars.shape[0])])


def expected_plane(expect: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``expected``'s verdicts in the stack's mapping, [B/32] int32 (the
    probe's ``pack_bool(expect[:, None], 1)``)."""
    return pack_bool(torch.from_numpy(expect[:, None]).to(dev), 1)[0]


def work(L: int, NW: int) -> Dict[str, int]:
    """What a verdict moves and computes: the stack read once and the
    verdict written (bytes), and the serial walk's int32 ops."""
    return {"nbytes": (PLANES * L * NW + NW) * 4, "int32_ops": OPS_A_POSITION * L * NW}
