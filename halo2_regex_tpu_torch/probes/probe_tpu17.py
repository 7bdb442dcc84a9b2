"""tools/probe_tpu17.py's Pallas probe on the H100: an int8 matrix product
with int32 sums.

- ``int8_mma(a, b)``: ``a @ b`` in int32 of int8 a [M, K] and b [K, N]
  (the probe's ``k``: ``dot_general`` with ``preferred_element_type=
  int32``), by wgmma m64nNk32 s8 x s8 -> s32 fed by TMA (``csrc/
  probe_int8_mma.cu``): two launches a call, a staging pass that writes
  b^T into scratch (wgmma reads int8 only K-major), then the product
  kernel.  Timed at the probe's 128^3 (a in [0, 2), b in [0, 100), as it
  drew them) and at 4096^3 over the whole int8 range, beside
  ``torch._int_mm``.

The script's other two lines, ``L1024_full_correct`` and
``fused3_autoTB``, run the JAX ``PallasMatcher`` and have no
``pallas_call`` of their own: their counterpart on the card is
chip_smoke.py's ``pallas_from`` path (the table kernels B8-B11 on the
from: model at B = 32768 x L = 1024, held to the oracle).  Run on the
card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu17

(``--device cpu`` runs the plain version at small widths).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..utils import profiling
from . import harness

WIDTHS = (128, 4096)  # M = N = K
MAX_K = (2**31 - 1) // (128 * 128)  # int32 sums exact: |a b| <= 2^14 a term
LAUNCHES = 2  # a call: the staging pass, then the product kernel
INT8_PEAK = profiling.spec_for_kind(profiling.H100_KIND)["int8_ops"]  # the H100 SXM's, dense


def _check(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2 or a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"a, b: expected 2-D int8, got {a.dtype}{tuple(a.shape)} and "
                         f"{b.dtype}{tuple(b.shape)}")
    M, K = a.shape
    if b.shape[0] != K or min(M, K, b.shape[1]) == 0:
        raise ValueError(f"a [M, K] @ b [K, N]: got {tuple(a.shape)} @ {tuple(b.shape)}")
    if K > MAX_K:
        raise ValueError(f"K {K} > {MAX_K}: the int32 sums could wrap")
    return M, b.shape[1], K


def int8_mma_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` exactly: a float64 product (every term and partial sum is
    an integer under 2^53), then int32."""
    _check(a, b)
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_mma_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``int8_mma`` kernel: the staging pass writes b^T (and, where
    TMA cannot read a in place, a padded copy of a) into scratch that this
    wrapper allocates, then the product kernel."""
    M, N, K = _check(a, b)
    kernels._check(a, "a", torch.int8, (M, K))
    kernels._check(b, "b", torch.int8, (K, N))
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lib = kernels.build_probes()
    scratch = torch.empty(lib.h2r_int8_mma_scratch(a.data_ptr(), M, N, K), dtype=torch.int8,
                          device=a.device)
    kernels._launch(kernels.INT8_MMA, lib.h2r_int8_mma, a.data_ptr(), b.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), M, N, K, kernels._stream(a),
                    n=LAUNCHES)
    return out


def int8_mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    return int8_mma_plain(a, b) if a.device.type == "cpu" else int8_mma_cuda(a, b)


def inputs(M: int, N: int, K: int, seed: int = 0, probe: bool = False, dev=None):
    """a [M, K] and b [K, N] int8, seeded: the probe's ranges ([0, 2) and
    [0, 100)) or the whole int8 range."""
    rng = np.random.default_rng(seed)
    lo_a, hi_a, lo_b, hi_b = (0, 2, 0, 100) if probe else (-128, 128, -128, 128)
    a = rng.integers(lo_a, hi_a, size=(M, K)).astype(np.int8)
    b = rng.integers(lo_b, hi_b, size=(K, N)).astype(np.int8)
    return torch.from_numpy(a).to(dev or "cpu"), torch.from_numpy(b).to(dev or "cpu")


def run(dev: torch.device, widths: Sequence[int] = WIDTHS) -> List[dict]:
    """``int8_mma`` at each n^3 of ``widths`` (the first at the probe's
    value ranges), ``torch._int_mm`` beside it: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for i, n in enumerate(widths):
        a, b = inputs(n, n, n, seed=n, probe=i == 0, dev=dev)
        recs.append(harness.measure(
            timer, card, f"int8_matmul_{n}", kernels.INT8_MMA, lambda: int8_mma(a, b), 1,
            lambda: int8_mma_plain(a, b), library=lambda: torch._int_mm(a, b), calls=LAUNCHES,
            nbytes=2 * n * n + 4 * n * n, int32_ops=0, mma_flops=2 * n**3, mma_peak=INT8_PEAK,
            shape=[n, n, n], ranges="probe" if i == 0 else "int8")[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu17.py's int8 product: int8_mma at 128^3 and 4096^3 "
                       "(the CPU: 64^3)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, (64,) if dev.type == "cpu" else WIDTHS)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
