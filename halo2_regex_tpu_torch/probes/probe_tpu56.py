"""tools/probe_tpu56.py's A on the H100: the issue width, as C = 1, 2 or 4
independent chains.

``chains(x, n_steps=4096)``: each of the C rows of x [C, 8, 128] int32
goes through ``n_steps`` steps of ``x = (x ^ (x << 1)) & (x >> 1)``, int32
as JAX computes it (``<<`` wraps, ``>>`` is arithmetic).  If the kernel's
time a step stays flat as C grows, a warp issues independent chains side
by side.  The kernel (``csrc/probe_tpu56.cu``) runs at two geometries:
blocks of 32 threads (the bitplane scan's: a warp an SM) or one block of
1024 (32 warps on one SM), in two forms (``form``):

- ``"fixed"``, the default: the map reaches a fixed point within a few
  steps on most inputs (17 on the probe's, 21 over 33.5 M seeded starts),
  after which every step is the identity; so after each group of 4 steps
  a warp whose every word v has f(v) = v stops, and its output is still
  exactly n_steps steps' (a word that never gets there runs them all).
  ``chains_steps(dev)`` reads the most steps a warp ran in the last such
  call (each warp writes its own into a slot of a buffer); ``chains_fixed_plain`` is its torch twin;
- ``"serial"``: every step run, the form that measures the issue width.

Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu56

(``--device cpu`` runs the plain version with 64 steps).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness

N_STEPS = 4096  # the probe's
CHAINS = (1, 2, 4)
THREADS = (32, 1024)  # a block: the bitplane scan's geometry, or one SM's worth
FORMS = ("fixed", "serial")
GROUP = 4  # the fixed form's steps between checks
_STEPS: Dict[int, torch.Tensor] = {}  # device -> the last fixed-form call's steps a warp


def chains_form(form: Optional[str]) -> str:
    """The form a call runs: ``form``, or ``"fixed"`` where it is None;
    raises on an unknown form."""
    if form is None:
        return "fixed"
    if form not in FORMS:
        raise ValueError(f"form {form!r}: expected one of {FORMS}")
    return form


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


def _step(x: torch.Tensor) -> torch.Tensor:
    return (x ^ (x << 1)) & (x >> 1)


def chains_fixed_plain(x: torch.Tensor, n_steps: int = N_STEPS) -> Tuple[torch.Tensor, int]:
    """The fixed form on torch tensors: the output (``chains_plain``'s) and
    the most steps a warp ran.  A warp is 32 consecutive words of a row
    (all C rows at once; words past a whole warp are 0); after each group
    of ``GROUP`` steps a warp whose every word has f(v) = v stops there,
    any other runs all n_steps."""
    c = _check(x, n_steps)
    nw = x[0].numel()
    v = torch.zeros((c, -(-nw // 32) * 32), dtype=x.dtype, device=x.device)
    v[:, :nw] = x.reshape(c, nw)
    v = v.reshape(c, -1, 32)
    ran = torch.full((v.shape[1],), n_steps, dtype=torch.int64, device=x.device)
    done = torch.zeros(v.shape[1], dtype=torch.bool, device=x.device)
    i = 0
    while i + GROUP <= n_steps and not bool(done.all()):
        for _ in range(GROUP):
            v = torch.where(done[None, :, None], v, _step(v))
        i += GROUP
        now = (_step(v) == v).all(2).all(0) & ~done
        ran[now] = i
        done |= now
    for _ in range(n_steps - i):
        v = torch.where(done[None, :, None], v, _step(v))
    out = v.reshape(c, -1)[:, :nw].reshape(x.shape).contiguous()
    return out, int(ran.max()) if ran.numel() else 0


def chains_cuda(x: torch.Tensor, n_steps: int = N_STEPS, threads: int = 32,
                form: Optional[str] = None) -> torch.Tensor:
    """The ``chains`` kernel in ``form`` (``chains_form``), ``threads``
    threads a block (32 or 1024)."""
    form = chains_form(form)
    c = _check(x, n_steps)
    if threads not in THREADS:
        raise ValueError(f"threads {threads}: expected one of {THREADS}")
    kernels._check(x, "x", torch.int32, tuple(x.shape))
    out = torch.empty_like(x)
    lib = kernels.build_probes()
    steps = None
    if form == "fixed":  # every warp writes its slot: the buffer needs no zeroing
        n_warps, dev = -(-x[0].numel() // threads) * threads // 32, kernels._index(x.device)
        steps = _STEPS.get(dev)
        if steps is None or steps.numel() != n_warps:
            steps = _STEPS[dev] = torch.empty(n_warps, dtype=torch.int32, device=x.device)
        steps = steps.data_ptr()
    kernels._launch(kernels.CHAINS, lib.h2r_chains, x.data_ptr(), out.data_ptr(), c,
                    x[0].numel(), n_steps, threads, steps, kernels._stream(x))
    return out


def chains_steps(dev: torch.device) -> int:
    """The most steps a warp ran in the last fixed-form call on ``dev`` (0
    before the first; reads the warps' slots: synchronises)."""
    steps = _STEPS.get(kernels._index(dev))
    return 0 if steps is None or not steps.numel() else int(steps.max())


def chains(x: torch.Tensor, n_steps: int = N_STEPS, threads: int = 32,
           form: Optional[str] = None) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one
    (``threads`` is the kernel's geometry and ``form`` its form: the result
    is the same)."""
    chains_form(form)
    if x.device.type == "cpu":
        return chains_plain(x, n_steps)
    return chains_cuda(x, n_steps, threads, form)


def inputs(c: int, seed: int = 0, dev: Optional[torch.device] = None) -> torch.Tensor:
    """An input as the probe's for C chains: (C, 8, 128) int32 over the
    whole range (at C = 1 and seed 0 the probe's own)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**31), 2**31 - 1, size=(c, 8, 128), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(x).to(dev or "cpu")


def run(dev: torch.device, n_steps: int = N_STEPS) -> List[dict]:
    """A line for each C, geometry and form (``harness.measure``; the plain
    version once a C, shared by all), with the chains' ops a second.  A
    fixed-form line's ops are those of the steps its twin
    (``chains_fixed_plain``) runs on these inputs, its check a group
    included, and it holds the steps its last call ran (``chains_steps``)
    beside its twin's."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for c in CHAINS:
        x = inputs(c, dev=dev)
        plain, ran = None, n_steps
        if dev.type == "cuda":
            tp = timer(lambda: chains_plain(x, n_steps), 0, 1)
            plain = (tp["out"], tp["median"])
            ran = chains_fixed_plain(x, n_steps)[1]
        for th in THREADS:  # the plain version (on the CPU) ignores the geometry
            for form in FORMS:
                steps = n_steps if form == "serial" else ran + ran // GROUP
                rec, out = harness.measure(
                    timer, card, "A_chains", kernels.CHAINS,
                    lambda: chains(x, n_steps, th, form), n_steps, plain,
                    nbytes=2 * x.numel() * 4, int32_ops=4 * steps * x.numel(), C=c,
                    threads=th, form=form, shape=list(x.shape))
                rec["nonzero_words"] = int((out != 0).sum())
                if dev.type == "cuda":  # 4 ops a step a chain: 2 shifts, an xor, an and
                    rec["gops_per_s"] = 4 * steps * x.numel() / (rec["ms"] * 1e-3) / 1e9
                    if form == "fixed":
                        rec["steps_run"], rec["steps_plain"] = chains_steps(dev), ran
                recs.append(rec)
                if dev.type != "cuda":
                    break  # the plain version once: both forms are the same function
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
