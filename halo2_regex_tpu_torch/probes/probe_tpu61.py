"""tools/probe_tpu61.py's C on the H100: the marker-stream verdict against
the scan kernel, timed by the slope of chained calls.

- C (``make_marker_kernel`` :228, pallas_call at :237): at B=32768 and
  B=4096 x L=1024 on the probes' corpus (``probe_tpu64.probe_corpus``,
  seed 0: the recipe of tools/probe_tpu61.py:64-76): K2 with the probe's
  plan (``probe_tpu57.scan_line``'s: the from: witness, en_pack and qpack
  off), the plain verdict (the probe's ``marker_xla``) and the
  ``marker_match`` kernel serial and at each chunk length of
  ``probe_tpu57_lib.CHUNKS``.  Each is first held as
  :mod:`.probe_tpu57` holds it (K2 against its plain scan, every verdict
  against Python ``re``), then timed by the probe's slope: K = 8 and 64
  calls chained (``harness.wall_slope``: the device slope from CUDA events
  with a spin ahead, the wall's beside it), ``ROUNDS`` rounds.  A round
  whose device slope is under the floor -- the call's traffic at
  ``COPY_GBPS``, the card's copy rate (PERF.md §6), where the probe took
  its device's HBM rate -- is discarded as the probe discards it; the
  line gives the median and best of the rest.  A chain rotates over copies
  of its input that together pass twice the 50 MB L2, so each call reads
  device memory, as each TPU call read HBM.

A (the stage budget: raw_quads, pack, scan, post, fb_only) and B (match
against witness) are chip_smoke's kernel timings and paths ([4], [6]).
Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu61

(``--device cpu`` runs the plain versions at B=4096 x L=128, chains of 2
and 4, one round: host times, no floor.)
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..ops import bitplane as bp
from ..ops import kernels
from . import harness
from . import probe_tpu57_lib as lib
from .probe_tpu57 import marker_lines, scan_line
from .probe_tpu64 import batch, from_model
from .probe_tpu67 import COPY_GBPS

BATCHES = (32768, 4096)
L_BIG = 1024
SMALL = ((4096,), 128)  # the CPU's batches and L
KS = (8, 64)  # the probe's KS_KERN
ROUNDS = 5  # the probe's H2R_PROBE_ROUNDS
L2_BYTES = 50 * 1024 * 1024


def copies(x: torch.Tensor, traffic: int) -> List[torch.Tensor]:
    """``x`` and enough copies of it that a chain over them moves more than
    twice the L2 between reuses of one."""
    n = max(1, math.ceil(2 * L2_BYTES / max(traffic, 1))) if x.is_cuda else 1
    return [x] + [x.clone() for _ in range(n - 1)]


def slope_line(dev: torch.device, card: str, probe: str, fn: Callable[[torch.Tensor], object],
               inputs: Sequence[torch.Tensor], traffic: int, ks=KS, rounds: int = ROUNDS,
               **kw) -> dict:
    """The probe's ``measure``: the slope of chains of ``fn`` over
    ``inputs`` in turn, rounds under the floor discarded, median and best
    of the rest (ms a call)."""
    def chain(k: int):
        y = None
        for i in range(k):
            y = fn(inputs[i % len(inputs)])
        return y

    sl = harness.wall_slope(dev, chain, ks, rounds)
    rec = {"probe": probe, "device": dev.type, "card": card, "traffic_bytes": traffic,
           "copies": len(inputs), **kw, **sl}
    if dev.type == "cuda":
        floor = traffic / (COPY_GBPS * 1e9) * 1e3
        kept = [s for s in sl["device_slope_ms"]["all"] if s > floor]
        rec.update(floor_ms=floor, copy_gbps=COPY_GBPS, kept=len(kept))
        if kept:
            rec.update(median_ms=float(np.median(kept)), best_ms=min(kept),
                       traffic_gbps_median=traffic / (float(np.median(kept)) * 1e-3) / 1e9)
    else:
        rec["host_slope_ms"] = sl["slope_ms"]["median"]
    return rec


def section_c(dev: torch.device, batches: Sequence[int] = BATCHES, L: int = L_BIG,
              ks=KS, rounds: int = ROUNDS) -> List[dict]:
    """C at each batch: the held lines (``probe_tpu57.marker_lines`` and
    ``scan_line``, one call each, device time), then each slope line."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs: List[dict] = []
    for B in batches:
        chars, lengths = batch(B, L, dev)
        c_np, l_np = chars.cpu().numpy(), lengths.cpu().numpy()
        want = lib.expected_plane(lib.expected(c_np, l_np), dev)
        stack = lib.marker_stack(chars, lengths)
        tag = f"c_{B // 1024}k"
        recs += marker_lines(timer, card, tag, stack, want)
        recs.append(scan_line(timer, card, tag, chars, lengths))
        plan = bp.BitplaneMatcher(from_model(L), columns="witness", en_pack=False, qpack=False,
                                  device=dev).plan
        bits, _ = bp.pack(plan, bp.raw_quads(chars, plan.L_pad), bp.len_table(lengths))
        NW = B // 32
        scan_traffic = bits.numel() * 4 + plan.L_pad * plan.sb_sum * NW * 4
        marker_traffic = lib.work(L, NW)["nbytes"]
        stacks = copies(stack, marker_traffic)
        recs.append(slope_line(dev, card, f"{tag}_scan_kernel", lambda b: bp.scan(plan, b),
                               copies(bits, scan_traffic), scan_traffic, ks, rounds,
                               kernel=kernels.SCAN.name, shape=[B, L]))
        recs.append(slope_line(dev, card, f"{tag}_marker_plain", lib.marker_match_reduced_plain,
                               stacks, marker_traffic, ks, rounds, kernel=None, shape=[B, L]))
        for chunk in (L,) + lib.CHUNKS:
            form = "serial" if chunk == L else f"chunk{chunk}"
            recs.append(slope_line(dev, card, f"{tag}_marker_{form}",
                                   lambda s, c=chunk: lib.marker_match(s, c), stacks,
                                   marker_traffic, ks, rounds, kernel=kernels.MARKER_MATCH.name,
                                   form=form, shape=[B, L]))
        del stacks
    return recs


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """C at the probe's batches; ``small``: B=4096 x L=128, chains of 2 and
    4, one round (the CPU)."""
    if small:
        return section_c(dev, SMALL[0], SMALL[1], (2, 4), 1)
    return section_c(dev)


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu61.py's C: the marker verdict (plain, serial, chunked) "
                       "against K2 at B=32768 and 4096 x L=1024, by the slope of 8 and 64 "
                       "chained calls with the copy-rate floor (the CPU: small sizes)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
