"""Every witness emission knob value end to end on the zk-email from:
model at L=64 (the pack and scan knobs:
tests/test_torch_variants_from_pack.py), and a
nine-def model whose id sum is wider than 8 bits (the planes fallback),
against the JAX matcher with the same knobs (see
tests/test_torch_variants_e2e.py).  Tolerance 0, dtypes included."""

import numpy as np
import pytest
import torch

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher

import halo2_regex_tpu_torch as T

from fixtures import CONFIGS
from test_torch_bitplane import _build, corpus
from test_torch_variants_e2e import EMIT_VALUES, N, as_numpy, assert_same, case_id, run_both


@pytest.fixture(scope="module")
def from_models():
    return _build(J, jzoo, "from"), _build(T, T.zoo, "from")


def check_from_value(monkeypatch, from_models, kw):
    chars, lengths = corpus("from", N, 71)
    got, want = run_both(monkeypatch, *from_models, "witness", kw, chars, lengths)
    assert_same(got, want)
    assert want["match_ok"].any()


@pytest.mark.parametrize("kw", EMIT_VALUES, ids=case_id)
def test_from_witness_knob_value_matches_jax(monkeypatch, from_models, kw):
    check_from_value(monkeypatch, from_models, kw)


NINE_L = 16


@pytest.fixture(scope="module")
def nine_defs():
    """Nine regex3 defs: 9 substrings, so idb = 4 and the id sum has
    4 + 4 + 1 = 9 planes."""
    return tuple(
        pkg.CompiledRegexModel.from_decomposed(
            [pkg.DecomposedRegexConfig.from_json(CONFIGS["regex3"])] * 9, max_chars_size=NINE_L)
        for pkg in (J, T))


def test_wide_id_sum_takes_the_planes_emission(nine_defs):
    """A witness field wider than 8 bits: the JAX matcher falls back to the
    planes emission and the port does the same, with the same outputs
    (all_substr_ids int32); the port raised NotImplementedError before."""
    jm, tm = nine_defs
    m = T.BitplaneMatcher(tm, columns="witness", device="cpu")
    assert (m.plan.nsum, m.plan.emit) == (9, "planes")
    rng = np.random.default_rng(9)
    pieces = [b"from:", b"a@b", b".c", b"\r\n", b"<", b">", b"x"]
    chars = np.zeros((64, NINE_L), np.uint8)
    lengths = np.zeros((64,), np.int32)
    matching = [b"from:a@b.c\r\n", b"from:a<b@c>\r\n", b"x\r\nfrom:ab@c\r\n"]
    for i in range(64):
        s = b"".join(pieces[j] for j in rng.integers(0, len(pieces), size=4))[:NINE_L]
        s = matching[i % 8] if i % 8 < len(matching) else s
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    got = as_numpy(m(chars, lengths))
    j = JaxMatcher(jm, columns="witness", interpret=True)
    assert j._emit == "planes"
    assert_same(got, as_numpy(j(chars, lengths)))
    assert got["all_substr_ids"].dtype == np.int32 and got["match_ok"].any()
