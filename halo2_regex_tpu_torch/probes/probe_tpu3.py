"""tools/probe_tpu3.py's Pallas probes (all through its ``vmem_call``) on
the H100: a gather by a [TB, 1] index, the one-hot DFA step with its two
extractions, and the gather loop.

- 1 ``k1``: ``take_along_axis(g, idx[:, 0:1], -1)`` broadcast to [TB,
  128] at TB 64 (g in [0, 999)): ``lane_gather(g, f)`` with f the index
  column broadcast.
- 2 ``make_scan_fullwidth``: ``dfa_step(..., "onehot_mma", time_major=True,
  pick="gather")`` at TB 256, 512 x LB 512 (the state picked by a
  full-width gather).
- 3 ``make_scan_select``: the same with ``pick="sum"`` (a one-hot select
  sum) at TB 256, 512, 1024.
- 5 ``k3``: ``lane_gather(g, f, 1024)`` on [256, 128] (probe_tpu2's E
  without its unroll).

The kernels are :mod:`.probe_tpu`'s.  The script's 4
(``mxu_verified_2048``: a bf16 product at 2048 against float32) is timed
as torch ops, ``"kernel": null``.  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu3

(``--device cpu`` runs the plain versions at small widths).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import harness
from .probe_tpu import LANES, bytes_, dfa_line, gather_inputs, gather_line, table

K1_TB = 64
LB = 512
FULL_TB = (256, 512)
SELECT_TB = (256, 512, 1024)
LOOP = (256, 1024)  # the gather loop's rows and steps


def k1_inputs(tb: int = K1_TB, seed: int = 0, dev=None):
    """k1's g [TB, 128] in [0, 999) and f [TB, 128]: each row's index
    idx[:, 0] in [0, 128) broadcast, as ``take_along_axis`` with a [TB, 1]
    index gives it."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.integers(0, 999, size=(tb, LANES)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, LANES, size=(tb, 8)).astype(np.int32))
    return g.to(dev or "cpu"), idx[:, 0:1].expand(tb, LANES).contiguous().to(dev or "cpu")


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """1, 2, 3 and 5 (a line each, ``harness.measure``) and 4 (torch).
    ``small``: TB 16, LB 32, 16 steps and a small product (the CPU run)."""
    if small:
        k1_tb, lb, full_tb, select_tb, loop, mm = 16, 32, (16,), (16,), (4, 16), 64
    else:
        k1_tb, lb, full_tb, select_tb, loop, mm = K1_TB, LB, FULL_TB, SELECT_TB, LOOP, 2048
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    g, f = k1_inputs(k1_tb, dev=dev)
    recs += gather_line(timer, card, "1_take_along_TBx1", g, f, 1, "shared")
    T = table().to(dev)
    for pick, probe, tbs in (("gather", "scan_fullwidth", full_tb),
                             ("sum", "scan_select", select_tb)):
        for tb in tbs:
            c = bytes_(lb, tb, seed=tb + 11, dev=dev)
            recs.append(dfa_line(timer, card, f"{probe}_{tb}x{lb}", T, c, "onehot_mma", True,
                                 pick))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((mm, mm)).astype(np.float32)).to(dev)
            for _ in range(2))
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    rec, out = harness.torch_line(timer, card, f"mxu_verified_{mm}",
                                  lambda: torch.matmul(ab, bb), shape=[mm, mm], flops=2 * mm**3)
    ref = torch.matmul(a, b)
    rec["rel_err"] = float((out.float() - ref).abs().mean() / ref.abs().mean())
    recs.append(rec)
    g, f = gather_inputs(loop[0], seed=9, dev=dev)
    recs += gather_line(timer, card, f"5_take_along_loop_{loop[0]}x128", g, f, loop[1],
                        "shared")
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu3.py's probes: lane_gather (k1, the loop) and "
                       "dfa_step's two extractions at the probe's widths (the CPU: small ones)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
