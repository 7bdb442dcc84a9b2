"""tools/probe_tpu68.py's Pallas probe on the H100: the exact decode forms
on the from: batch's own g4, and the whole witness with each of them.

- A: ``field_decode`` (:mod:`.probe_tpu64`) in its ``"mma_select"`` (the
  probe's "mx": the selector on the tensor cores) and ``"swap"`` ("sw":
  the int32 tile transpose and a four-column pack) forms on the g4 of the
  shipped witness front (K1 qpack, K2 scan, K3 post in bytes mode) at
  B=32768 x L=1024, each held against the plain decode and against B14's
  ``decode`` on the same g4, which is timed beside them.
- B: ``witness_pipeline(m, chars, lengths, form)``, the probe's
  ``pipeline_k``: the same front, ``field_decode`` in ``form``, then the
  kdecode tail (``decode_columns``, ``states_column``,
  ``finish_witness``), for each form; its ``WITNESS_KEYS`` must equal
  ``BitplaneMatcher(model, columns="witness")``'s (the bytes emission).
  Its wall is timed in turns with the shipped bytes, kdecode and direct
  witness, ``ROUNDS`` rounds in one window, as the probe's round robin;
  each wall is a torch line (device time, ``harness.Timer``).

Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu68

(``--device cpu`` runs the plain versions at B=4096 x L=128, one round of
one call).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import bitplane as bp
from ..ops import kernels
from ..ops.bitplane import TILE
from . import harness
from .probe_tpu64 import (BIG, FORMS, SMALL, assert_same, batch, chars_l4, columns_u8,
                          decode_line, decode_work, field_decode, fields_of, from_model)

WITNESS_KEYS = ("states", "all_substr_ids", "masked_characters", "flags", "match_ok")
ROUNDS, ITERS = 4, 3  # B's round robin: rounds, timed calls a pipeline a round


def front(plan: bp.BitplanePlan, chars: torch.Tensor, lengths: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shipped witness front: qpack (K1, with its enable plane), the
    scan, the post kernel in bytes mode -> g4 and the boundary planes."""
    if not (plan.qpack and plan.en_pack and plan.emit == "bytes") or plan.L_pad != plan.L:
        raise ValueError("the front needs a witness plan in bytes emission with qpack and "
                         "en_pack (L_pad == L)")
    bits, en = bp.qpack(plan, chars, bp.len_table(lengths))
    return bp.post(plan, bp.scan(plan, bits), en)


def witness_pipeline(m: bp.BitplaneMatcher, chars: torch.Tensor, lengths: torch.Tensor,
                     form: str) -> Dict[str, torch.Tensor]:
    """The probe's pipeline_k: the front, ``field_decode`` in ``form``, the
    kdecode tail; a batch of a multiple of 4096 strings."""
    plan, tables = m.plan, m.tables()
    B = chars.shape[0]
    if B % TILE:
        raise ValueError(f"{B} strings: the pipeline takes a multiple of {TILE}")
    g4, fb = front(plan, chars, lengths)
    cols = field_decode(g4, chars_l4(chars), fields_of(plan), form)
    names = [name for name, *_ in plan.fields_flat] + ["masked_characters_pre"]
    vals = bp.decode_columns(plan, cols, names, B)
    vals["states"] = bp.states_column(tables, vals, plan.n_defs)
    return bp.finish_witness(tables, vals, fb, B, B, chars)


def same_witness(name: str, got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> None:
    for k in WITNESS_KEYS:
        if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k]):
            raise AssertionError(f"probe_tpu68 {name}: {k} differs from the shipped witness's")


def section_a(timer, card, m: bp.BitplaneMatcher, kplan: bp.BitplanePlan, chars: torch.Tensor,
              lengths: torch.Tensor) -> List[dict]:
    """A: B14 and the mma_select and swap forms on the front's g4, each
    held against the plain decode and B14's output."""
    plan = m.plan
    g4, _fb = front(plan, chars, lengths)
    ch_l4 = chars_l4(chars)
    fields = fields_of(plan)
    rec, b14 = harness.measure(timer, card, "a_b14_decode", kernels.DECODE,
                               lambda: bp.decode(kplan, g4, ch_l4), 1,
                               lambda: bp.decode_plain(kplan, g4, ch_l4),
                               n_fields=len(fields), **decode_work(g4, len(fields) + 1))
    recs = [rec]
    for form in ("mma_select", "swap"):
        rec, out = decode_line(timer, card, f"a_{form}_decode", g4, ch_l4, fields, form)
        assert_same(f"a_{form}_decode against B14", columns_u8(out, plan.L),
                    columns_u8(b14, plan.L))
        recs.append(dict(rec, equals_b14=True))
    return recs


def section_b(timer, card, m: bp.BitplaneMatcher, shipped: Dict[str, bp.BitplaneMatcher],
              chars: torch.Tensor, lengths: torch.Tensor, rounds_: int = ROUNDS,
              iters: int = ITERS) -> List[dict]:
    """B: each form's pipeline held to the shipped witness, then every
    pipeline's wall in turns (``rounds_`` rounds of ``iters`` calls)."""
    want = m(chars, lengths)
    pipes = [(f"b_{name}_shipped", (lambda mm=mm: mm(chars, lengths)))
             for name, mm in shipped.items()]
    for form in FORMS:
        same_witness(form, witness_pipeline(m, chars, lengths, form), want)
        pipes.append((f"b_{form}_pipeline",
                      (lambda form=form: witness_pipeline(m, chars, lengths, form))))
    rounds: Dict[str, List[float]] = {name: [] for name, _ in pipes}
    for rnd in range(rounds_):
        for name, fn in pipes:
            rounds[name].append(timer(fn, 1 if rnd == 0 else 0, iters)["median"])
    B, L = chars.shape
    recs = []
    for name, _ in pipes:
        ms = float(np.median(rounds[name]))
        rec = {"probe": name, "kernel": None, "device": timer.dev.type, "card": card,
               "shape": [B, L], "runs": rounds_ * iters, "round_ms": rounds[name],
               "witness_equal": True}
        if timer.dev.type == "cuda":
            rec.update(ms=ms, iqr=[float(v) for v in np.percentile(rounds[name], [25, 75])],
                       input_gbps=B * L / (ms * 1e-3) / 1e9)
        else:
            rec["host_ms"] = ms
        recs.append(rec)
    return recs


def run(dev: torch.device, small: bool = False) -> List[dict]:
    """Sections A and B on the from: batch (B=32768 x L=1024; ``small``:
    B=4096 x L=128, the CPU)."""
    timer, card = harness.Timer(dev), harness.card(dev)
    B, L = SMALL if small else BIG
    model = from_model(L)
    m = bp.BitplaneMatcher(model, columns="witness", device=dev)
    shipped = {emit: bp.BitplaneMatcher(model, columns="witness", emit=emit, device=dev)
               for emit in ("bytes", "kdecode", "direct")}
    if [mm.plan.emit for mm in shipped.values()] != ["bytes", "kdecode", "direct"]:
        raise AssertionError("probe_tpu68: an emission no longer resolves as named")
    chars, lengths = batch(B, L, dev)
    return (section_a(timer, card, m, shipped["kdecode"].plan, chars, lengths)
            + section_b(timer, card, m, shipped, chars, lengths,
                        *((1, 1) if small else (ROUNDS, ITERS))))


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu68.py's probe: the decode forms on the from: batch's g4 "
                       "(A) and the witness pipeline with each, in turns with the shipped "
                       "emissions (B) (the CPU: B=4096 x L=128)")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu")
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
