"""tools/probe_tpu30.py's workarounds on the H100: the configs[3] step
(hi/lo, ``s mod S``) over a 1-D grid with a scratch carry (w1), over the
whole segment from an entry-state input (w2), and chained (w3).

Each is :mod:`.probe_tpu28`'s ``dfa_wide`` with ``hilo`` and ``smod`` on
the probe's table [96, 2016] in [0, 256) and chars [4096, 128] in [0, 96):

- w1 (:65): from state 0 (the carry across its 4 chunks is the scan
  itself), lookup and onehot_mma against one plain output;
- w2 (:99): the same from an entry state, seeded here in [0, S) (the
  probe's was zero, which is w1);
- w3 (``chained`` :128, never called by the probe; its ``repeat(2, 0)``
  doubles every row, so each of its segments would scan its half with
  every byte twice): two launches, the second entered at the first's last
  row, as the segmented design means; ``chained`` equals one launch over
  all of L from the same entry.

Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu30

(``--device cpu`` runs the plain versions at [256, 16]).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import kernels
from . import harness
from .probe_tpu28 import (as_table, b_fragments, dfa_wide, dfa_wide_plain, plain_once,
                          wide_line, wide_work)

TB, K, S = 128, 96, 1008
L = 4096  # 4 chunks of 1024
FLAGS = dict(hilo=True, smod=True)


def probe_inputs(L_: int, TB_: int, seed: int = 0, dev: Optional[torch.device] = None):
    """The probe's draws: tbl [96, 2016] f32 in [0, 256) (as bf16), then
    chars [L, TB] in [0, 96); and an entry state [TB] in [0, S) for w2."""
    rng = np.random.default_rng(seed)
    tbl = rng.integers(0, 256, size=(K, 2 * S)).astype(np.float32)
    chars = rng.integers(0, K, size=(L_, TB_)).astype(np.int32)
    entry = rng.integers(0, S, size=TB_).astype(np.int32)
    d = dev or "cpu"
    return as_table(tbl).to(d), torch.from_numpy(chars).to(d), torch.from_numpy(entry).to(d)


def chained(tbl: torch.Tensor, chars: torch.Tensor, entry: Optional[torch.Tensor] = None,
            form: str = "lookup", frags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """w3 as the segmented design means it: the first half of L from
    ``entry``, the second from the first's last row; the two halves'
    states concatenated."""
    half = chars.shape[0] // 2
    out1 = dfa_wide(tbl, chars[:half].contiguous(), entry=entry, form=form, frags=frags,
                    **FLAGS)
    out2 = dfa_wide(tbl, chars[half:].contiguous(), entry=out1[-1], form=form, frags=frags,
                    **FLAGS)
    return torch.cat([out1, out2], 0)


def run(dev: torch.device, L_: int = L, TB_: int = TB) -> List[dict]:
    """w1 and w2 in both forms, w3 (two lookup launches) against one
    launch's plain output: a line each."""
    timer, card = harness.Timer(dev), harness.card(dev)
    tbl, chars, entry = probe_inputs(L_, TB_, dev=dev)
    recs = []
    for probe, e in (("w1_1dgrid_scratch", None), ("w2_seg_kernel", entry)):
        want = plain_once(timer, lambda: dfa_wide_plain(tbl, chars, entry=e, **FLAGS))
        for form in ("lookup", "onehot_mma"):
            recs.append(wide_line(timer, card, probe, tbl, chars, form, want, entry=e,
                                  **FLAGS)[0])
    want = plain_once(timer, lambda: dfa_wide_plain(tbl, chars, entry=entry, **FLAGS))
    frags = b_fragments(tbl) if chars.is_cuda else None
    KW = tbl.shape
    recs.append(harness.measure(
        timer, card, "w3_chained", kernels.DFA_WIDE,
        lambda: chained(tbl, chars, entry, "lookup", frags), L_, want, calls=2, form="lookup",
        shape=[L_, TB_], K=KW[0], S=KW[1] // 2, segments=2, **FLAGS,
        **wide_work(KW[0], KW[1], L_, TB_, "lookup"))[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu30.py's w1, w2 and w3: the configs[3] step (dfa_wide) "
                       f"at K={K}, S={S}, [{L}, {TB}] (the CPU: [256, 16])")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, 256, 16) if dev.type == "cpu" else run(dev)
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
