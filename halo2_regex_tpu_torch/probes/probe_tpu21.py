"""tools/probe_tpu21.py's D on the H100: a bf16 product added into an f32
accumulator carried over the second grid axis.

- ``mma_accum(a, b)``: a [NI, NL, M, K] and b [NI, NL, K, N] bf16 -> out
  [NI, NL, M, N] f32, ``out[i, l] = sum over l' <= l of a[i, l'] @
  b[i, l']`` (the probe's ``mm_kern``: its scratch zeroed at l = 0, then
  ``scr + dot(a, b)`` stored at every l).  probe_tpu20.py's D is the same
  kernel with block shapes that make it raise (:mod:`.probe_tpu20`).

The kernel is ``csrc/probe_mma_accum.cu``'s ``mma_accum`` (128 x 128
tiles, 128 x 256 where N > 128, by bf16 ``wgmma`` from a TMA ring, the
accumulators carried across l in registers, each l's sum out by TMA
stores); M and N multiples of 64 and K of 32 on the card (a tile past a
matrix's edge is zero-filled and clipped by its 3-D tensor maps).  The
library call beside it is ``torch.matmul(a, b).float().cumsum(1)`` (its products are
rounded to bf16, so it is timed and its difference recorded, not held).
The tolerance: bit-exact on integer-valued inputs (the probe's all-ones,
and integers in [-8, 8]: every partial sum an integer under 2^24); on
N(0, 1) inputs at most ``TOL`` x sum |a b| of each output (f32 sums of 128
l products taken in another order).  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu21

(``--device cpu`` runs the plain version at the probe's width).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu import BF16_PEAK

SHAPE = (4, 2, 128, 128)  # the probe's a and b: [NI, NL, 128, 128]
BIG = (4, 8, 1024, 1024)  # a larger tile stack, integer inputs: the tensor-core rate
KINDS = ("ones", "ints", "normal")
TOL = 2e-5  # of sum |a b|: f32 sums of up to 128 l terms in another order


def _check(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int, int, int]:
    if a.dim() != 4 or b.dim() != 4 or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f"a, b: expected [NI, NL, M, K] and [NI, NL, K, N] bf16, got "
                         f"{a.dtype}{tuple(a.shape)} and {b.dtype}{tuple(b.shape)}")
    NI, NL, M, K = a.shape
    if tuple(b.shape[:3]) != (NI, NL, K) or 0 in a.shape or b.shape[3] == 0:
        raise ValueError(f"b: expected [{NI}, {NL}, {K}, N], got {tuple(b.shape)}")
    return NI, NL, M, K, b.shape[3]


def mma_accum_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The probe's body step by step: acc = 0, then ``acc = acc + a[:, l] @
    b[:, l]`` in f32 at each l, every acc stored."""
    _check(a, b)
    acc = torch.zeros((a.shape[0], a.shape[2], b.shape[3]), dtype=torch.float32,
                      device=a.device)
    outs = []
    for l in range(a.shape[1]):
        acc = acc + torch.matmul(a[:, l].float(), b[:, l].float())
        outs.append(acc)
    return torch.stack(outs, 1)


def mma_accum_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``mma_accum`` kernel: M and N multiples of 64, K of 32, a and b
    16-byte aligned."""
    NI, NL, M, K, N = _check(a, b)
    if M % 64 or N % 64 or K % 32:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)}: mma_accum needs M and N "
                         f"multiples of 64 and K a multiple of 32")
    kernels._check(a, "a", torch.bfloat16, (NI, NL, M, K))
    kernels._check(b, "b", torch.bfloat16, (NI, NL, K, N))
    kernels._check_aligned(a, "a", 16)
    kernels._check_aligned(b, "b", 16)
    out = torch.empty((NI, NL, M, N), dtype=torch.float32, device=a.device)
    lib = kernels.build_probes()
    kernels._launch(kernels.MMA_ACCUM, lib.h2r_mma_accum, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), NI, NL, M, N, K, kernels._stream(a))
    return out


def mma_accum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    return mma_accum_plain(a, b) if a.device.type == "cpu" else mma_accum_cuda(a, b)


def mma_accum_library(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One PyTorch call of the same function (bf16 products, then the
    running sum in f32)."""
    return torch.matmul(a, b).float().cumsum(1)


def tolerance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``TOL`` x the running sum of |a| @ |b|: each output's bound."""
    return TOL * torch.matmul(a.float().abs(), b.float().abs()).cumsum(1)


def inputs(shape=SHAPE, kind: str = "ones", seed: int = 0,
           dev: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """a of ``shape`` ([NI, NL, M, K]) and b [NI, NL, K, M] in bf16: the
    probe's all-ones, integers in [-8, 8], or N(0, 1) values rounded to
    bf16, seeded."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    rng = np.random.default_rng(seed)
    out = []
    for shape in (tuple(shape), (*shape[:2], shape[3], shape[2])):
        if kind == "ones":
            v = np.ones(shape, np.float32)
        elif kind == "ints":
            v = rng.integers(-8, 9, size=shape).astype(np.float32)
        else:
            v = rng.standard_normal(shape).astype(np.float32)
        out.append(torch.from_numpy(v).to(dev or "cpu", torch.bfloat16))
    return out[0], out[1]


def accum_line(timer, card, probe: str, a: torch.Tensor, b: torch.Tensor, kind: str) -> dict:
    """A ``mma_accum`` measurement (``harness.measure``): a step is one
    (i, l) product; the tolerance on N(0, 1) inputs, exact otherwise."""
    NI, NL, M, K, N = _check(a, b)
    flops = 2 * NI * NL * M * K * N
    rec = harness.measure(
        timer, card, probe, kernels.MMA_ACCUM, lambda: mma_accum(a, b), NI * NL,
        lambda: mma_accum_plain(a, b), library=lambda: mma_accum_library(a, b),
        library_exact=False, tolerance=tolerance(a, b) if kind == "normal" else None,
        nbytes=(a.numel() + b.numel()) * 2 + NI * NL * M * N * 4, int32_ops=0,
        mma_flops=flops, mma_peak=BF16_PEAK, shape=[NI, NL, M, N], inputs=kind)[0]
    if "ms" in rec:
        rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    return rec


def run(dev: torch.device, big: bool = True) -> List[dict]:
    """D at the probe's [4, 2, 128, 128] on each kind of input, and with
    ``big`` integer inputs at [4, 8, 1024, 1024]: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for kind in KINDS:
        a, b = inputs(SHAPE, kind, seed=1, dev=dev)
        recs.append(accum_line(timer, card, "D_mxu_2dgrid_scratch", a, b, kind))
    if big:
        a, b = inputs(BIG, "ints", seed=2, dev=dev)
        recs.append(accum_line(timer, card, "D_mxu_2dgrid_scratch", a, b, "ints"))
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu21.py's D: the bf16 product accumulated over the "
                       "second grid axis (mma_accum) at [4, 2, 128, 128], and at "
                       "[4, 8, 1024, 1024] on the card")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, big=dev.type == "cuda")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
