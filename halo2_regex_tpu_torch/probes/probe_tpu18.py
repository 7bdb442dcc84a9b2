"""tools/probe_tpu18.py's Pallas probe on the H100: the cost anatomy of the
slab kernel, its table step stripped to 1, 2 or 4 picks and stores.

- ``slab_anatomy(tab, classes, x, first, n_out)``: on the from: model's
  class table, per step the class of byte x[i, b] (the probe's
  thresholds: the class map of the byte clamped to [0, 256)), then
  ``n_out`` picks ``v_j = tab[class, j * S + s]`` at the state s, s = v_0,
  from ``first``; ``n_out`` [L, B] int32 outputs, time-major.  The probe's
  ``scan_only``, ``scan_ids`` and ``scan_all4`` are n_out 1, 2 and 4, at
  L = 1024 x B = 4096 with bytes in [32, 127).

The kernel is ``csrc/probe_tpu18.cu``, probe_tpu9's slab kernel
(``csrc/probe_slab.cuh``) with the pick and store count a template
parameter, in its chunked form by default or its serial one (``form``, as
:mod:`.probe_tpu9`'s ``slab_scan``); the plain version is
:mod:`.probe_tpu9`'s ``slab_plain``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu18

(``--device cpu`` runs the plain version at L = 64 x B = 64).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import zoo
from ..ops import kernels
from ..ops.pallas_scan import build_packed_tables, byte_classes
from . import harness
from .probe_tpu9 import _check_x, check_table, scan_form, slab_launch, slab_plain

L, B = 1024, 4096  # the probe's
N_OUTS = {1: "scan_only", 2: "scan_ids", 4: "scan_all4"}


def slab_tables(model) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The probe's ``build``: def 0's packed table collapsed to its byte
    classes, the class table padded to a multiple of 8 rows (kp), the
    class map, and the model's first state.  Returns (tab [kp, 4S] int32,
    classes [256] int32, first)."""
    class_of, ctab = byte_classes(build_packed_tables(model)[0])
    kdim = ctab.shape[0]
    kp = -(-max(kdim, 8) // 8) * 8
    tab = np.zeros((kp, ctab.shape[1]), np.int32)
    tab[:kdim] = ctab
    return (torch.from_numpy(tab), torch.from_numpy(class_of.astype(np.int32)),
            int(model.first_states[0]))


def _check(tab: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int,
           n_out: int) -> Tuple[int, int, int, int]:
    if n_out not in N_OUTS:
        raise ValueError(f"n_out {n_out}: expected one of {tuple(N_OUTS)}")
    K, S = check_table(tab, classes)
    if not 0 <= first < S:
        raise ValueError(f"first {first}: expected a state in [0, S = {S})")
    L_, B_ = _check_x(x)
    return K, S, L_, B_


def check_ranges(tab: torch.Tensor, classes: torch.Tensor) -> None:
    """The state column keeps a state in the table: tab[:, :S] in [0, S);
    classes in [0, K).  On the card it waits for the device, so the plain
    version checks it and the kernel's wrapper leaves it to its caller."""
    K, S = check_table(tab, classes)
    if bool(((tab[:, :S] < 0) | (tab[:, :S] >= S)).any()):
        raise ValueError(f"tab: the state column's values must lie in [0, S = {S})")
    if bool(((classes < 0) | (classes >= K)).any()):
        raise ValueError(f"classes: values must lie in [0, K = {K})")


def slab_anatomy_plain(tab: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int,
                       n_out: int = 4):
    """``slab_plain`` from ``first`` with ``n_out`` outputs; it checks
    the ranges (``check_ranges``)."""
    _check(tab, classes, x, first, n_out)
    check_ranges(tab, classes)
    return slab_plain(tab, classes, x, first, n_out)


def slab_anatomy_cuda(tab: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int,
                      n_out: int = 4, form: Optional[str] = None):
    """The ``slab_anatomy`` kernel in ``form`` (None: ``kernels.slab_form``'s).
    Precondition (``check_ranges``; not checked here)."""
    _check(tab, classes, x, first, n_out)
    return slab_launch(kernels.SLAB_ANATOMY, tab, classes, x, first, n_out, form)


def slab_anatomy(tab: torch.Tensor, classes: torch.Tensor, x: torch.Tensor, first: int,
                 n_out: int = 4, form: Optional[str] = None):
    """The kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        scan_form(form, check_table(tab, classes)[1])
        return slab_anatomy_plain(tab, classes, x, first, n_out)
    return slab_anatomy_cuda(tab, classes, x, first, n_out, form)


def inputs(L_: int, B_: int, seed: int = 0, dev=None):
    """The probe's bytes: x [L, B] int32 in [32, 127), seeded."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(32, 127, size=(L_, B_)).astype(np.int32)).to(dev or "cpu")


def run(dev: torch.device, L_: int = L, B_: int = B) -> List[dict]:
    """``slab_anatomy`` at n_out 1, 2 and 4 on the from: model's table at
    [L, B]: a line each (``harness.measure``; ns a step over L)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    model = zoo.email_headers_model(max_chars_size=L_, headers=("from",))
    tab, classes, first = (v.to(dev) if isinstance(v, torch.Tensor) else v
                           for v in slab_tables(model))
    x = inputs(L_, B_, dev=dev)
    recs = []
    for n_out, probe in N_OUTS.items():
        recs.append(harness.measure(
            timer, card, probe, kernels.SLAB_ANATOMY,
            lambda: slab_anatomy(tab, classes, x, first, n_out), L_,
            lambda: slab_anatomy_plain(tab, classes, x, first, n_out),
            nbytes=((1 + n_out) * x.numel() + tab.numel() + 256) * 4,
            int32_ops=(1 + n_out) * x.numel(), shape=[L_, B_], n_out=n_out,
            K=tab.shape[0], S=tab.shape[1] // 4, form=scan_form(None, tab.shape[1] // 4))[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu18.py's slab anatomy: slab_anatomy with 1, 2 and 4 "
                       f"outputs at [{L}, {B}] (the CPU: [64, 64])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 64, 64) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
