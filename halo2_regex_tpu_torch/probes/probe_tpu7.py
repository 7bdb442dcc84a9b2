"""tools/probe_tpu7.py's scan_kernel on the H100: the one-hot DFA step at
S = 32 and 128, its column picked by a select sum or ``take_along_axis``,
over one chunk of 64 positions or two with the state carried between.

Each case (``CASES``, the probe's A-E) is :mod:`.probe_tpu28`'s
``dfa_wide`` on T [256, S] in [0, S) (``s = T[c, s]`` from 0) and bytes
[L, 128], L = 64, or 128 for the two-chunk cases; the pick and the
chunking do not change the function, so each case runs the lookup and
the product form (``onehot_mma``) against one plain output.  The inputs
are drawn as the probe draws them: one generator, each case's T then its
bytes.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu7

(``--device cpu`` runs the plain version).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import harness
from .probe_tpu28 import as_table, dfa_wide_plain, plain_once, wide_line

TB, LC = 128, 64
# the probe's cases: (S, the pick, two chunks with a scratch carry)
CASES: Dict[str, Tuple[int, str, bool]] = {
    "A_sel_S128_grid1": (128, "select", False),
    "B_sel_S32_grid1": (32, "select", False),
    "C_ta_S32_grid2": (32, "ta", True),
    "D_sel_S128_grid2": (128, "select", True),
    "E_ta_S128_grid2": (128, "ta", True),
}


def inputs(seed: int = 0, dev: Optional[torch.device] = None
           ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each case's (T as bf16, bytes [L, TB] int32), drawn in the probe's
    order from one generator."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (S, _extract, grid2) in CASES.items():
        T = rng.integers(0, S, size=(256, S)).astype(np.int32)
        x = rng.integers(0, 256, size=(LC * (2 if grid2 else 1), TB)).astype(np.int32)
        out[name] = (as_table(T).to(dev or "cpu"), torch.from_numpy(x).to(dev or "cpu"))
    return out


def run(dev: torch.device, forms=("lookup", "onehot_mma")) -> List[dict]:
    """A-E, each form against one plain output: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for name, (T, x) in inputs(dev=dev).items():
        _S, extract, grid2 = CASES[name]
        want = plain_once(timer, lambda: dfa_wide_plain(T, x))
        for form in forms:
            recs.append(wide_line(timer, card, name, T, x, form, want, extract=extract,
                                  chunks=2 if grid2 else 1)[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu7.py's cases A-E: the widened DFA step (dfa_wide, "
                       "lookup and onehot_mma) at S = 32 and 128, [64 or 128, 128]")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
