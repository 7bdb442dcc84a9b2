"""tools/probe_tpu31.py's padding sweep on the H100: the configs[3] step
(hi/lo, ``s mod S``, an entry-state input of zeros: probe_tpu30's w2) at
six (K, S).

Each (K, S) of ``SIZES`` is :mod:`.probe_tpu28`'s ``dfa_wide`` with
``hilo`` and ``smod`` on the probe's draws: the table [K, 2S] in [0, 256)
as bf16, then chars [2048, 128] in [0, min(K, 95)), one generator in the
sweep's order; lookup (in shared memory up to 96 x 1024, from global
memory at 128 x 1008 and 128 x 1024) and onehot_mma against one plain
output.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu31

(``--device cpu`` runs the plain version at [256, 16]).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import harness
from .probe_tpu28 import as_table, dfa_wide_plain, plain_once, wide_line

TB, L = 128, 2048
SIZES: Tuple[Tuple[int, int], ...] = ((96, 1008), (128, 1008), (96, 1024), (128, 1024),
                                      (96, 512), (96, 128))
FLAGS = dict(hilo=True, smod=True)


def inputs(L_: int = L, TB_: int = TB, seed: int = 0, dev: Optional[torch.device] = None):
    """Each (K, S)'s (table as bf16, chars [L, TB] int32), drawn in the
    probe's order."""
    rng = np.random.default_rng(seed)
    out = {}
    for K, S in SIZES:
        tbl = rng.integers(0, 256, size=(K, 2 * S)).astype(np.float32)
        chars = rng.integers(0, min(K, 95), size=(L_, TB_)).astype(np.int32)
        out[(K, S)] = (as_table(tbl).to(dev or "cpu"), torch.from_numpy(chars).to(dev or "cpu"))
    return out


def run(dev: torch.device, L_: int = L, TB_: int = TB) -> List[dict]:
    """Every (K, S) in both forms: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for (K, S), (tbl, chars) in inputs(L_, TB_, dev=dev).items():
        want = plain_once(timer, lambda: dfa_wide_plain(tbl, chars, **FLAGS))
        for form in ("lookup", "onehot_mma"):
            recs.append(wide_line(timer, card, f"K{K}_S{S}", tbl, chars, form, want,
                                  **FLAGS)[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu31.py's sweep: the configs[3] step (dfa_wide) at six "
                       f"(K, S), [{L}, {TB}] (the CPU: [256, 16])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 256, 16) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
