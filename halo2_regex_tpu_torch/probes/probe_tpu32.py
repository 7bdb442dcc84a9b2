"""tools/probe_tpu32.py's feature matrix on the H100: the DFA step plain,
hi/lo, with ``s mod S``, and over two chunks with a scratch carry.

Each case of ``CASES`` (the probe's a-f) is :mod:`.probe_tpu28`'s
``dfa_wide`` on the probe's draws: ts [K, S] in [0, S), the table ts (f32)
or, with hi/lo, [ts & 255, ts >> 8], taken as the body reads it (bf16),
then chars [2048, 128] in [0, K); lookup and onehot_mma against one plain
output.  Case c (96 x 1008, no hi/lo) is not the integer scan of ts: bf16
rounds 500 of the table's values in [256, 1008), and 1006 and 1007 to
1008, past the last state, which the next step maps to state 0.  Its
line records where the scan first leaves the integer scan and the largest
state; d, e and f are exact.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu32

(``--device cpu`` runs the plain version at [256, 16]).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import harness
from .probe_tpu28 import as_table, dfa_wide_plain, plain_once, wide_line

TB, L = 128, 2048
# the probe's cases: (K, S, hi/lo, s mod S, two chunks with a scratch carry)
CASES: Dict[str, Tuple[int, int, bool, bool, bool]] = {
    "a_K16_S24": (16, 24, False, False, False),
    "b_K96_S128": (96, 128, False, False, False),
    "c_K96_S1008_single": (96, 1008, False, False, False),
    "d_K96_S1008_hi_lo": (96, 1008, True, False, False),
    "e_d_modulo": (96, 1008, True, True, False),
    "f_d_2dgrid_scratch": (96, 1008, True, False, True),
}


def inputs(L_: int = L, TB_: int = TB, seed: int = 0, dev: Optional[torch.device] = None
           ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each case's (table as bf16, chars [L, TB] int32, ts int64), drawn in
    the probe's order from one generator."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (K, S, hi_lo, _mod, _g2) in CASES.items():
        ts = rng.integers(0, S, size=(K, S)).astype(np.int64)
        tbl = (np.concatenate([ts & 0xFF, ts >> 8], 1) if hi_lo else ts).astype(np.float32)
        chars = rng.integers(0, K, size=(L_, TB_)).astype(np.int32)
        d = dev or "cpu"
        out[name] = (as_table(tbl).to(d), torch.from_numpy(chars).to(d), torch.from_numpy(ts))
    return out


def integer_scan(ts: torch.Tensor, chars: torch.Tensor, modulo: bool) -> torch.Tensor:
    """The probe's numpy reference: ``s = ts[c, s]`` (mod S) from 0, the
    table's integers unrounded."""
    S = ts.shape[1]
    s = torch.zeros(chars.shape[1], dtype=torch.int64)
    flat, c = ts.reshape(-1), chars.cpu().long()
    out = []
    for i in range(c.shape[0]):
        s = flat[c[i] * S + s]
        if modulo:
            s = s % S
        out.append(s)
    return torch.stack(out).to(torch.int32)


def exactness(got: torch.Tensor, ts: torch.Tensor, chars: torch.Tensor, modulo: bool) -> dict:
    """Whether a scan equals the integer scan of ts, its first difference
    [position, string] and its largest state."""
    ref = integer_scan(ts, chars, modulo)
    diff = (got.cpu() != ref).nonzero()
    return {"exact": not len(diff), "first_difference": diff[0].tolist() if len(diff) else None,
            "max_state": int(got.max())}


def run(dev: torch.device, L_: int = L, TB_: int = TB) -> List[dict]:
    """a-f in both forms: a line each, with the case's exactness against
    the integer scan."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for name, (tbl, chars, ts) in inputs(L_, TB_, dev=dev).items():
        _K, _S, hi_lo, modulo, grid2 = CASES[name]
        flags = dict(hilo=hi_lo, smod=modulo)
        want = plain_once(timer, lambda: dfa_wide_plain(tbl, chars, **flags))
        ex = exactness(want[0], ts, chars, modulo)
        for form in ("lookup", "onehot_mma"):
            rec = wide_line(timer, card, name, tbl, chars, form, want,
                            chunks=2 if grid2 else 1, **flags)[0]
            rec.update(ex)
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu32.py's cases a-f: the DFA step (dfa_wide) plain, hi/lo, "
                       f"modulo, two chunks, at [{L}, {TB}] (the CPU: [256, 16])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 256, 16) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
