"""tools/probe_tpu56.py's A on the H100: the issue width, as C = 1, 2 or 4
independent chains.

``chains(x, n_steps=4096)``: each of the C rows of x [C, 8, 128] int32
goes through ``n_steps`` steps of ``x = (x ^ (x << 1)) & (x >> 1)``, int32
as JAX computes it (``<<`` wraps, ``>>`` is arithmetic).  If the kernel's
time a step stays flat as C grows, a warp issues independent chains side
by side.  The kernel (``csrc/probe_tpu56.cu``) runs at two geometries:
blocks of 32 threads (the bitplane scan's: a warp an SM) or one block of
1024 (32 warps on one SM).  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu56

(``--device cpu`` runs the plain version with 64 steps).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import kernels
from . import harness

N_STEPS = 4096  # the probe's
CHAINS = (1, 2, 4)
THREADS = (32, 1024)  # a block: the bitplane scan's geometry, or one SM's worth


def _check(x: torch.Tensor, n_steps: int) -> int:
    if x.dim() != 3 or x.shape[0] not in CHAINS or x.dtype != torch.int32:
        raise ValueError(f"x: expected [C, ...] int32 with C in {CHAINS}, got "
                         f"{x.dtype}{tuple(x.shape)}")
    if n_steps < 0:
        raise ValueError(f"n_steps {n_steps} must not be negative")
    return x.shape[0]


def chains_plain(x: torch.Tensor, n_steps: int = N_STEPS) -> torch.Tensor:
    """The steps one after another on the whole of x."""
    _check(x, n_steps)
    for _ in range(n_steps):
        x = (x ^ (x << 1)) & (x >> 1)
    return x


def chains_cuda(x: torch.Tensor, n_steps: int = N_STEPS, threads: int = 32) -> torch.Tensor:
    """The ``chains`` kernel, ``threads`` threads a block (32 or 1024)."""
    c = _check(x, n_steps)
    if threads not in THREADS:
        raise ValueError(f"threads {threads}: expected one of {THREADS}")
    kernels._check(x, "x", torch.int32, tuple(x.shape))
    out = torch.empty_like(x)
    lib = kernels.build_probes()
    kernels._launch(kernels.CHAINS, lib.h2r_chains, x.data_ptr(), out.data_ptr(), c,
                    x[0].numel(), n_steps, threads, kernels._stream(x))
    return out


def chains(x: torch.Tensor, n_steps: int = N_STEPS, threads: int = 32) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one
    (``threads`` is the kernel's geometry: the result is the same)."""
    if x.device.type == "cpu":
        return chains_plain(x, n_steps)
    return chains_cuda(x, n_steps, threads)


def inputs(c: int, seed: int = 0, dev: Optional[torch.device] = None) -> torch.Tensor:
    """An input as the probe's for C chains: (C, 8, 128) int32 over the
    whole range (at C = 1 and seed 0 the probe's own)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31 - 1, size=(c, 8, 128), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(dev or "cpu")


def run(dev: torch.device, n_steps: int = N_STEPS) -> List[dict]:
    """A line for each C and geometry (``harness.measure``; the plain
    version once a C, shared by both geometries), with the chains' ops a
    second."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for c in CHAINS:
        x = inputs(c, dev=dev)
        plain = None
        if dev.type == "cuda":
            tp = timer(lambda: chains_plain(x, n_steps), 0, 1)
            plain = (tp["out"], tp["median"])
        for th in THREADS:  # the plain version (on the CPU) ignores the geometry
            rec, out = harness.measure(
                timer, card, "A_chains", kernels.CHAINS, lambda: chains(x, n_steps, th),
                n_steps, plain, nbytes=2 * x.numel() * 4, int32_ops=4 * n_steps * x.numel(),
                C=c, threads=th, shape=list(x.shape))
            rec["nonzero_words"] = int((out != 0).sum())
            if dev.type == "cuda":  # 4 ops a step a chain: 2 shifts, an xor, an and
                rec["gops_per_s"] = 4 * n_steps * x.numel() / (rec["ms"] * 1e-3) / 1e9
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = harness.parser(f"tools/probe_tpu56.py's A: independent chains (the issue width), "
                       f"{N_STEPS} steps (the CPU: 64)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 64 if dev.type == "cpu" else N_STEPS)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
