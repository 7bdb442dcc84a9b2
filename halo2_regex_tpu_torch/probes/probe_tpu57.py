"""tools/probe_tpu57.py's B, C, D and E on the H100: the marker-stream
verdict against the DFA scan, and the package's matchers on two
configurations that no other probe runs.

- B (``make_marker_kernel`` :190, pallas_call at :198): the restricted
  from: verdict (:mod:`.probe_tpu57_lib`) at B=32768 x L=1024 on the
  probes' corpus (``probe_tpu64.probe_corpus``, seed 0: the recipe of
  tools/probe_tpu57.py:54-71) from the stack of ``pack_bytes`` /
  ``pack_bool`` planes: the plain version on the card (the probe's
  ``marker_xla`` leg, a torch line), then the ``marker_match`` kernel
  serial and at each chunk length of ``probe_tpu57_lib.CHUNKS``; every
  verdict equals Python ``re``'s (``PY_PATTERN``, packed by
  ``pack_bool(expect[:, None], 1)``, :157-167).  Beside them K2 on the
  same corpus with the probe's plan (``BitplaneMatcher(model,
  columns="witness", en_pack=False, qpack=False)``: ``bp.pack`` on
  ``raw_quads``, then ``bp.scan``, :251-253), held against its plain scan.
- C: the same at B=4096, the corpus's first 4096 strings (NWS = 1).
- D (:311-350): the from: model at max_chars_size 65536, B=4096 strings
  of the probe's recipe (a filler, then a from: line; seed 0 in this
  module's own rng: the TPU run's rng state is not reproduced):
  ``BitplaneMatcher(columns="witness")`` beside ``PallasMatcher`` (its
  segmented grid, one pass over L on the card) on the same batch; each
  call's ``match_ok`` and masked characters equal the C++ oracle's
  (``native.native_result``) on the first 64 rows.
- E (:352-418): the structured model (tag: then one of 200 seeded words
  then \\r\\n, ``DecomposedRegexConfig``, 693 live states) at B=32768 x
  L=1024 of random printable bytes, the witness asked for in ``bytes``
  emission at unroll 1 and in ``kdecode`` with en_pack at unroll 4 (its
  state field takes 10 bits, so both plans resolve to the planes emission,
  as the JAX matcher's do: the lines record ``emit_resolved``), each held
  against the C++ oracle on 64 rows.

A and F (the emission modes, en_pack, qpack and unroll of the witness; the
match-only path) are chip_smoke's knob paths and match path ([4]-[6]).
Each kernel line is ``harness.measure``'s; D's and E's walls are torch
lines (one call, device time).  Run on the card::

    python -m halo2_regex_tpu_torch.probes.probe_tpu57

(``--device cpu`` runs the plain versions at small sizes: B and C at B=4096
x L=128, D at 64 x 512, E at 64 x 1024.)
"""

from __future__ import annotations

import functools
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..compiler.decomposed import DecomposedRegexConfig
from ..models.compiled import CompiledRegexModel
from ..models import zoo
from ..ops import bitplane as bp
from ..ops import kernels
from ..ops.pallas_scan import PallasMatcher
from . import harness
from . import probe_tpu57_lib as lib
from .probe_tpu64 import batch, from_model

BIG = (32768, 1024)  # B: the from: batch
SMALL = (4096, 128)  # the CPU's
C_BATCH = 4096  # C: one word group
D_SHAPE = (4096, 65536)  # D: B x max_chars_size
D_SMALL = (64, 512)
E_SHAPE = (32768, 1024)  # E: B x L (its config's max_byte_size)
E_SMALL = 64
ORACLE_ROWS = 64
# E's two witness plans (the probe's "struct bytes/u1" and "struct kdecode/enpack/u4")
E_PLANS = {"bytes_u1": {"emit": "bytes", "unroll": 1},
           "kdecode_enpack_u4": {"emit": "kdecode", "en_pack": True, "unroll": 4}}


# ------------------------------------------------------------- B and C


def marker_lines(timer, card: str, tag: str, stack: torch.Tensor, want: torch.Tensor,
                 chunks: Sequence[int] = lib.CHUNKS) -> List[dict]:
    """The plain verdict (a torch line) and the kernel serial and at each
    of ``chunks`` (``harness.measure`` lines against it); every verdict
    equals ``want`` (``re``'s)."""
    L, NW = stack.shape[1:]
    work = lib.work(L, NW)
    shape = [NW * 32, L]
    rec, plain = harness.torch_line(timer, card, f"{tag}_marker_plain",
                                    lambda: lib.marker_match_reduced_plain(stack),
                                    nbytes=work["nbytes"], shape=shape)
    recs = [rec]
    plain_ms = rec.get("ms", rec.get("host_ms"))
    for chunk in (L,) + tuple(c for c in chunks if L % c == 0):
        form = "serial" if chunk == L else f"chunk{chunk}"
        geo = {} if chunk == L else dict(zip(("cluster", "block_chunks", "warps"),
                                             lib.geometry(L, chunk)))
        rec, out = harness.measure(timer, card, f"{tag}_marker_{form}", kernels.MARKER_MATCH,
                                   lambda c=chunk: lib.marker_match(stack, c), L,
                                   (plain, plain_ms), form=form, chunk=chunk, shape=shape,
                                   **geo, **work)
        recs.append(rec)
        for what, v in (("plain", plain), (form, out)):
            if not torch.equal(v, want):
                raise AssertionError(f"probe_tpu57 {tag}: the {what} verdict differs from re's")
    for r in recs:
        r["equals_re"] = True
    return recs


def scan_line(timer, card: str, tag: str, chars: torch.Tensor, lengths: torch.Tensor) -> dict:
    """K2 with the probe's plan (the from: witness, en_pack and qpack off):
    the bits from ``bp.pack`` on the raw quad rows, then ``bp.scan``, held
    against ``bp.scan_plain``."""
    B, L = chars.shape
    m = bp.BitplaneMatcher(from_model(L), columns="witness", en_pack=False, qpack=False,
                           device=chars.device)
    plan = m.plan
    bits, _ = bp.pack(plan, bp.raw_quads(chars, plan.L_pad), bp.len_table(lengths))
    NW = B // 32
    nbytes = bits.numel() * 4 + plan.L_pad * plan.sb_sum * NW * 4  # the bits in, the logs out
    ops = sum(c.step_ops for c in plan.circuits) * plan.L_pad * NW
    return harness.measure(timer, card, f"{tag}_scan_kernel", kernels.SCAN,
                           lambda: bp.scan(plan, bits), plan.L_pad,
                           lambda: bp.scan_plain(plan, bits), nbytes=nbytes, int32_ops=ops,
                           shape=[B, L])[0]


def section_bc(timer, card: str, dev: torch.device, B: int, L: int, tag: str
               ) -> List[dict]:
    """B (``tag`` "b") or C ("c"): the marker lines and K2 on the probes'
    corpus of ``B`` strings (C's 4096 are B's first: the recipe draws
    string by string)."""
    chars, lengths = batch(B, L, dev)
    c_np, l_np = chars.cpu().numpy(), lengths.cpu().numpy()
    want = lib.expected_plane(lib.expected(c_np, l_np), dev)
    stack = lib.marker_stack(chars, lengths)
    return marker_lines(timer, card, tag, stack, want) + [scan_line(timer, card, tag, chars,
                                                                     lengths)]


# ------------------------------------------------------------------ D


def d_corpus(B: int, L: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """D's strings (tools/probe_tpu57.py:319-328): a filler of up to L - 96
    bytes, then a from: line; chars [B, L] uint8, lengths [B] int32."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    alpha_sp = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz @.-:", np.uint8)
    chars = np.zeros((B, L), np.uint8)
    lengths = np.zeros((B,), np.int32)
    for i in range(B):
        filler = rng.choice(alpha_sp, size=int(rng.integers(0, L - 96))).tobytes()
        s = (filler + b"\r\nfrom:" + rng.choice(alpha, size=8).tobytes() + b"@gmail.com\r\n")[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


def _col(out, key: str) -> torch.Tensor:
    return out[key] if isinstance(out, dict) else getattr(out, key)


def oracle_check(name: str, out, model, chars: np.ndarray, lengths: np.ndarray,
                 keys: Sequence[str] = ("match_ok", "masked_characters")) -> None:
    """``out``'s first ``ORACLE_ROWS`` rows equal the C++ oracle's on
    ``keys`` (values; the matchers' dtypes differ)."""
    if not native.available():
        raise RuntimeError(f"probe_tpu57 {name}: the C++ oracle needs g++")
    n = ORACLE_ROWS
    nat = native.native_result(model, chars[:n], lengths[:n])
    for k in keys:
        got = _col(out, k)[:n].cpu().numpy().astype(np.int64)
        if not np.array_equal(got, np.asarray(getattr(nat, k)).astype(np.int64)):
            raise AssertionError(f"probe_tpu57 {name}: {k} differs from the C++ oracle")


def matcher_line(timer, card: str, probe: str, m, model, chars: torch.Tensor,
                 lengths: torch.Tensor, c_np: np.ndarray, l_np: np.ndarray, **kw) -> dict:
    """One matcher's call as a torch line (the wall of one call) with its
    rate of input, held against the oracle's rows."""
    B, L = chars.shape
    runs = {} if chars.is_cuda else {"warmup": 0, "iters": 1}  # the CPU: one call
    rec, out = harness.torch_line(timer, card, probe, lambda: m(chars, lengths),
                                  nbytes=B * L, shape=[B, L], **runs, **kw)
    oracle_check(probe, out, model, c_np, l_np)
    del out
    if "ms" in rec:
        rec["input_gbps"] = B * L / (rec["ms"] * 1e-3) / 1e9
    return dict(rec, equals_oracle_rows=ORACLE_ROWS)


@functools.lru_cache(maxsize=2)
def d_model(L: int):
    return zoo.email_headers_model(max_chars_size=L, headers=("from",))


def d_matchers(L: int, dev: torch.device) -> Dict[str, object]:
    """D's two matchers on the from: model at max_chars_size L."""
    model = d_model(L)
    return {"bitplane": bp.BitplaneMatcher(model, columns="witness", device=dev),
            "pallas": PallasMatcher(model, device=dev)}


def section_d(timer, card: str, dev: torch.device, B: int, L: int) -> List[dict]:
    """D: the witness and the table path on the 64 KB strings."""
    c_np, l_np = d_corpus(B, L)
    chars, lengths = torch.from_numpy(c_np).to(dev), torch.from_numpy(l_np).to(dev)
    model = d_model(L)
    recs = []
    for name, m in d_matchers(L, dev).items():
        extra = {"grid_mode": m.grid_mode} if name == "pallas" else {"L_pad": m.plan.L_pad}
        recs.append(matcher_line(timer, card, f"d_{name}", m, model, chars, lengths, c_np,
                                 l_np, **extra))
    return recs


# ------------------------------------------------------------------ E


@functools.lru_cache(maxsize=1)
def e_model():
    """E's structured model (tools/probe_tpu57.py:380-392): tag:, one of
    200 words of 5-8 seeded letters, \\r\\n; and the rng, past the words,
    that draws its corpus."""
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))
    rng = np.random.default_rng(1)
    letters = "abcdefghijklmnopqrstuvwxyz"
    words = sorted({"".join(letters[i] for i in rng.integers(0, 26, int(rng.integers(5, 9))))
                    for _ in range(200)})
    cfg = DecomposedRegexConfig.from_json({
        "max_byte_size": E_SHAPE[1],
        "parts": [
            {"is_public": False, "regex_def": "tag:", "max_size": 4},
            {"is_public": False, "regex_def": "(" + "|".join(words) + ")", "max_size": 16},
            {"is_public": False, "regex_def": "\r\n", "max_size": 2},
        ],
    })
    return CompiledRegexModel.from_decomposed([cfg], max_chars_size=E_SHAPE[1]), rng


def e_corpus(B: int) -> Tuple[np.ndarray, np.ndarray]:
    """E's bytes (:393-395): random printable bytes, every string full."""
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = e_model()[1].bit_generator.state  # a copy: every call draws alike
    return (rng.integers(32, 127, size=(B, E_SHAPE[1])).astype(np.uint8),
            np.full((B,), E_SHAPE[1], np.int32))


def e_matchers(dev: torch.device) -> Dict[str, bp.BitplaneMatcher]:
    model, _ = e_model()
    return {name: bp.BitplaneMatcher(model, columns="witness", device=dev, **kw)
            for name, kw in E_PLANS.items()}


def section_e(timer, card: str, dev: torch.device, B: int) -> List[dict]:
    """E: the structured model's witness in both plans."""
    model, _ = e_model()
    c_np, l_np = e_corpus(B)
    chars, lengths = torch.from_numpy(c_np).to(dev), torch.from_numpy(l_np).to(dev)
    recs = []
    for name, m in e_matchers(dev).items():
        c = m.plan.circuits[0]
        recs.append(matcher_line(timer, card, f"e_{name}", m, model, chars, lengths, c_np,
                                 l_np, step_ops=c.step_ops, live_states=len(c.live_states),
                                 emit_resolved=m.plan.emit, **E_PLANS[name]))
    return recs


def run(dev: torch.device, small: bool = False, sections: str = "BCDE") -> List[dict]:
    """The sections named (each line ``harness.measure``'s or a torch
    line); ``small``: the CPU's sizes."""
    timer, card = harness.Timer(dev), harness.card(dev)
    B, L = SMALL if small else BIG
    recs: List[dict] = []
    if "B" in sections:
        recs += section_bc(timer, card, dev, B, L, "b")
    if "C" in sections:
        recs += section_bc(timer, card, dev, C_BATCH, L, "c")
    if "D" in sections:
        recs += section_d(timer, card, dev, *(D_SMALL if small else D_SHAPE))
    if "E" in sections:
        recs += section_e(timer, card, dev, E_SMALL if small else E_SHAPE[0])
    return recs


def main(argv=None) -> int:
    p = harness.parser("tools/probe_tpu57.py's B and C (the marker-stream verdict, serial and "
                       "chunked, beside K2, at B=32768 and 4096 x L=1024), D (the from: model at "
                       "64 KB, bitplane and table paths) and E (the 200-word model's witness); "
                       "the CPU: small sizes")
    p.add_argument("--sections", default="BCDE", help="which of B, C, D, E to run")
    a = p.parse_args(argv)
    dev = harness.device(a.device)
    recs = run(dev, small=dev.type == "cpu", sections=a.sections.upper())
    harness.emit(recs)
    return harness.status(recs)


if __name__ == "__main__":
    raise SystemExit(main())
