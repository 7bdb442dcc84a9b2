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
kernel (``csrc/probe_tpu20.cu``) is built for the probe's sweep: n_ops in
``N_OPS``, sb = 5, k = 12.

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
runs the plain versions at L=256, NWS=1, n_ops 96).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def bitop_scan_cuda(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB, k: int = K,
                    lc: int = LC) -> torch.Tensor:
    """The ``bitop_scan`` kernel: n_ops in ``N_OPS``, sb = 5 and k = 12
    (compile-time constants of the kernel); any L and lc."""
    L_ = _check(cls, st0, n_ops, sb, k, lc)
    if n_ops not in N_OPS or (sb, k) != (SB, K):
        raise ValueError(f"the kernel is built for n_ops in {N_OPS}, sb={SB}, k={K}; got "
                         f"n_ops={n_ops}, sb={sb}, k={k}")
    nws = cls.shape[2]
    kernels._check(cls, "cls", torch.int32, (L_, k, nws, LANE))
    kernels._check(st0, "st0", torch.int32, (sb, nws, LANE))
    out = torch.empty((L_, 1, nws, LANE), dtype=torch.int32, device=cls.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.BITOP_SCAN, lib.h2r_bitop_scan, cls.data_ptr(), st0.data_ptr(),
                    out.data_ptr(), n_ops, nws * LANE, L_, lc, kernels._stream(cls))
    return out


def bitop_scan(cls: torch.Tensor, st0: torch.Tensor, n_ops: int, sb: int = SB, k: int = K,
               lc: int = LC) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if cls.device.type == "cpu":
        return bitop_scan_plain(cls, st0, n_ops, sb, k, lc)
    return bitop_scan_cuda(cls, st0, n_ops, sb, k, lc)


def inputs(L_: int, nws: int, seed: int = 0, dev: Optional[torch.device] = None):
    """Seeded class planes [L, K, NWS, 128] (as the probe's: 31 random
    bits a word) and start planes [SB, NWS, 128] over the whole range
    (the probe's are zero, and so is then its output)."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 2**31, size=(L_, K, nws, LANE)).astype(np.int32)
    st0 = rng.integers(-(2**31), 2**31, size=(SB, nws, LANE), dtype=np.int64).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev or "cpu") for a in (cls, st0))


def run(dev: torch.device, L_: int = L, nws: int = NWS,
        n_ops: Sequence[int] = N_OPS) -> List[dict]:
    """The sweep at [L, K, NWS, 128]: a line a value of n_ops
    (``harness.measure``), with the share of output words that are not
    zero."""
    cls, st0 = inputs(L_, nws, dev=dev)
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for n in n_ops:
        rec, out = harness.measure(
            timer, card, "A_bitop_scan", kernels.BITOP_SCAN, lambda: bitop_scan(cls, st0, n),
            L_, lambda: bitop_scan_plain(cls, st0, n),
            nbytes=(cls.numel() + st0.numel() + L_ * nws * LANE) * 4,
            int32_ops=n * L_ * nws * LANE, n_ops=n, shape=[L_, K, nws, LANE],
            strings=32 * nws * LANE)
        rec["nonzero_share"] = float((out != 0).float().mean())
        recs.append(rec)
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
