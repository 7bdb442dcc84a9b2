"""tools/probe_tpu20.py's A on the H100: a serial bit-op scan, swept over
ops a step, at the bitplane scan's geometry.

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
``N_OPS``, sb = 5, k = 12.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu20

(``--device cpu`` runs the plain version at L=256, NWS=1, n_ops 96).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import kernels
from . import harness

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


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu20.py's A: the serial bit-op scan, n_ops "
                       f"{', '.join(map(str, N_OPS))} at [{L}, {K}, {NWS}, {LANE}] (the CPU: "
                       f"96 at [256, {K}, 1, {LANE}])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 256, 1, (96,)) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
