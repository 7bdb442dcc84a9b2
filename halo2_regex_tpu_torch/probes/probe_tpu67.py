"""tools/probe_tpu67.py's A and C on the H100: what a launch costs past its
bytes, and how the witness pipeline's wall scales with the batch.

- A (the ``lambda`` copy body at :127, pallas_call at :126): an int32
  copy of [NBLK, 1024, 128] at NBLK = 64 (32 MB) and 4 (2 MB), timed by
  the slope of K chained calls (K = 8 and 64), each reading the last one's
  output: :mod:`.probe_tpu47`'s ``tile_move`` copy between two buffers
  (no op between launches), beside the same chain of ``x.clone()``.  The
  wall runs from the first enqueue to ``torch.cuda.synchronize()`` with the
  L2 flushed first and no spin ahead (``harness.wall_slope``), so the
  host's enqueue counts; the slope less the bytes at ``COPY_GBPS`` (the
  card's copy rate, PERF.md §6) is the fixed cost of a launch.  The device
  slope (a spin ahead, CUDA events) is recorded beside it.
- C: the port's witness pipeline (``BitplaneMatcher(columns="witness")``
  on the from: model) at B = 32768, 65536 and 131072 x L = 1024 on the
  probe's corpus (``probe_tpu64.probe_corpus``, seed 1 as the probe's),
  every witness key of every call kept, timed by the slope of 1 and 4
  chained calls.  Every batch's first 32768 rows equal the B = 32768
  call's (the corpus is the same there).  The probe's section B (the
  emission modes in turns) is :mod:`.probe_tpu68`'s B.

Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu67

(``--device cpu`` runs the plain versions at small sizes, host times).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..ops import bitplane as bp
from ..ops import kernels
from ..ops.bitplane import LANE
from . import harness
from .probe_tpu47 import tile_move, tile_move_plain, words
from .probe_tpu64 import from_model, probe_corpus

NBLKS = (64, 4)  # A: 32 MB and 2 MB
KS = (8, 64)  # A's chain lengths
C_BATCHES = (32768, 65536, 131072)
C_L = 1024
C_KS = (1, 4)  # C's chain lengths (the probe's ks)
RUNS = 5
COPY_GBPS = 2808.1  # the card's copy rate: probe_tpu's x + 1 on 256 MiB (PERF.md §6)
WITNESS_KEYS = ("states", "all_substr_ids", "masked_characters", "flags", "match_ok")


def copy_chain(x: torch.Tensor, y: torch.Tensor):
    """k ``tile_move`` copies back to back, each reading the last one's
    output (x, y, x, ...): a call of k."""
    def chain(k: int) -> torch.Tensor:
        src, dst = x, y
        for _ in range(k):
            tile_move(src, "copy", out=dst)
            src, dst = dst, src
        return src
    return chain


def clone_chain(x: torch.Tensor):
    """k ``clone`` calls, each of the last one's output."""
    def chain(k: int) -> torch.Tensor:
        y = x
        for _ in range(k):
            y = y.clone()
        return y
    return chain


def section_a(dev: torch.device, nblks: Sequence[int] = NBLKS, ks=KS,
              runs: int = RUNS) -> List[dict]:
    """A: for each NBLK the copy kernel's line (``harness.measure``: one
    call held against the plain copy, ``x.clone()`` its library call) with
    the slopes of its chain (``chain``) and of the clone chain
    (``clone_chain``)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    recs = []
    for nblk in nblks:
        x = words((nblk, 1024, LANE), seed=nblk, lo=0, hi=2**31, dev=dev)
        y = torch.empty_like(x)
        traffic = 2 * x.numel() * 4
        fixed = {"copy_gbps": COPY_GBPS, "bytes_ms": traffic / (COPY_GBPS * 1e9) * 1e3}
        probe = f"a_copy_{nblk * 1024 * LANE * 4 >> 20}mb"
        rec = harness.measure(timer, card, probe, kernels.TILE_MOVE, lambda: tile_move(x, "copy"),
                              nblk, lambda: tile_move_plain(x, "copy"),
                              library=lambda: x.clone(), nbytes=traffic,
                              shape=list(x.shape), form="copy")[0]
        for name, chain in (("chain", copy_chain(x, y)), ("clone_chain", clone_chain(x))):
            sl = harness.wall_slope(dev, chain, ks, runs)
            sl["fixed_ms"] = sl["slope_ms"]["median"] - fixed["bytes_ms"]
            if "device_slope_ms" in sl:
                sl["device_fixed_ms"] = sl["device_slope_ms"]["median"] - fixed["bytes_ms"]
            rec[name] = dict(sl, **fixed)
        recs.append(rec)
    return recs


def section_c(dev: torch.device, batches: Sequence[int] = C_BATCHES, L_: int = C_L,
              ks=C_KS, runs: int = 3) -> List[dict]:
    """C: the witness at each batch, a torch line each: the wall slope a
    call (host enqueue included) and the input rate at it."""
    card = harness.card(dev)
    m = bp.BitplaneMatcher(from_model(L_), columns="witness", device=dev)
    first: Optional[Dict[str, torch.Tensor]] = None
    recs = []
    for B in batches:
        chars_np, lengths_np = probe_corpus(B, L_, seed=1)
        chars = torch.from_numpy(chars_np.copy()).to(dev)
        lengths = torch.from_numpy(lengths_np.copy()).to(dev)
        kept: List[Dict[str, torch.Tensor]] = []

        def chain(k: int):
            kept.clear()  # every key of every call of this chain stays alive to its end
            for _ in range(k):
                kept.append(m(chars, lengths))
            return kept[-1]

        out = chain(1)
        if first is None:
            first = {k: out[k] for k in WITNESS_KEYS}
        n = first["match_ok"].shape[0]
        for k in WITNESS_KEYS:
            if not torch.equal(out[k][:n], first[k]):
                raise AssertionError(f"probe_tpu67 C: B={B}'s {k} differs from the first batch's "
                                     "on the rows they share")
        sl = harness.wall_slope(dev, chain, ks, runs)
        kept.clear()
        rec = {"probe": f"c_shipped_B{B // 1024}k", "kernel": None, "device": dev.type,
               "card": card, "shape": [B, L_], "keys": list(WITNESS_KEYS), **sl}
        if dev.type == "cuda":
            ms = sl["slope_ms"]["median"]
            rec.update(ms=ms, iqr=sl["slope_ms"]["iqr"], input_gbps=B * L_ / (ms * 1e-3) / 1e9)
        else:
            rec["host_ms"] = sl["slope_ms"]["median"]
        recs.append(rec)
    return recs


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """A and C at the probe's sizes; ``small``: A at [2, 1024, 128] and [1,
    1024, 128] with chains of 2 and 4, C at B = 4096 and 8192 x L = 128,
    one run each (the CPU)."""
    if small:
        return (section_a(dev, (2, 1), (2, 4), 1)
                + section_c(dev, (4096, 8192), 128, (1, 2), 1))
    return section_a(dev) + section_c(dev)


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu67.py's A (a copy's launch cost past its bytes: chains "
                       "of 8 and 64 at 32 MB and 2 MB) and C (the witness at B = 32768, 65536, "
                       "131072 x L = 1024); the CPU: small sizes")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
