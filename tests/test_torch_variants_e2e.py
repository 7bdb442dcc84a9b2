"""Every knob value of the port's BitplaneMatcher end to end against the
JAX matcher with the same knobs, on the regex3 model at L=64: the
witness emission's knobs here, the pack and scan knobs in
tests/test_torch_variants_e2e_pack.py (the two-def model:
tests/test_torch_variants_two_def*.py; the from: model:
tests/test_torch_variants_from*.py).

A value is given as a constructor argument or, for the ``H2R_*``-only
spellings (the legacy ``H2R_WITNESS_BYTES``), in the environment; both
matchers resolve it (JAX in interpret mode, the port on the CPU) and their
outputs are equal on every key, dtypes included (tolerance 0).  Also the
settings JAX ignores (an emission for columns="full"/"match"), the
``post="pallas"`` spelling.
"""

import numpy as np
import pytest
import torch

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher

import halo2_regex_tpu_torch as T

from test_torch_bitplane import STRINGS12, _build, corpus

N = 300  # strings per call (the pipeline pads them to 4096)

# knobs as constructor arguments, or as environment variables ("env"): the
# witness tail's, here, and the pack and scan knobs', in
# tests/test_torch_variants_e2e_pack.py (one file each keeps the
# interpret-mode JAX work of a file short)
EMIT_VALUES = [
    dict(emit="direct"), dict(emit="kdecode"), dict(emit="planes"), dict(emit="bytes"),
    dict(env={"H2R_WITNESS_BYTES": "0"}), dict(post="xla"),
]
PACK_VALUES = [
    dict(class_stage=False), dict(class_stage="onehot"), dict(en_pack=False), dict(qpack=False),
    dict(fuse_pack=True), dict(unroll=3),
]
EXTRA_VALUES = [  # the other column sets, on regex3
    ("full", dict(post="xla")), ("full", dict(class_stage="onehot", en_pack=False)),
    ("full", dict(fuse_pack=True)), ("match", dict(class_stage=False, en_pack=False)),
    ("match", dict(fuse_pack=True)),
]


def case_id(kw):
    kw = dict(kw)
    env = kw.pop("env", {})
    return ",".join([f"{k}={v}" for k, v in kw.items()] + [f"{k}={v}" for k, v in env.items()])


def as_numpy(out):
    out = out if isinstance(out, dict) else vars(out)
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in out.items()}


def lit_corpus(name, n, seed):
    """``corpus`` with, for the two-def model, two strings that match it in
    the first rows (its random pieces alone match nothing)."""
    chars, lengths = corpus(name, n, seed)
    if name == "two_def":
        for i, s in enumerate(STRINGS12[:2]):
            chars[i] = 0
            chars[i, : len(s)] = bytearray(s)
            lengths[i] = len(s)
    return chars, lengths


def run_both(monkeypatch, jmodel, tmodel, columns, kw, chars, lengths):
    """(port output, JAX output) as numpy dicts, under the same knobs."""
    kw = dict(kw)
    for var, value in kw.pop("env", {}).items():
        monkeypatch.setenv(var, value)
    jkw = dict(kw)
    got = T.BitplaneMatcher(tmodel, columns=columns, device="cpu", **kw)(chars, lengths)
    want = JaxMatcher(jmodel, columns=columns, interpret=True, **jkw)(chars, lengths)
    return as_numpy(got), as_numpy(want)


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def models():
    return {n: (_build(J, jzoo, n), _build(T, T.zoo, n)) for n in ("regex3", "two_def")}


def check_witness_value(monkeypatch, models, name, kw):
    chars, lengths = lit_corpus(name, N, 61)
    got, want = run_both(monkeypatch, *models[name], "witness", kw, chars, lengths)
    assert_same(got, want)
    assert want["match_ok"].any() and want["mask"].any()


@pytest.mark.parametrize("kw", EMIT_VALUES, ids=case_id)
def test_witness_knob_value_matches_jax(monkeypatch, models, kw):
    check_witness_value(monkeypatch, models, "regex3", kw)


@pytest.mark.parametrize("columns,kw", EXTRA_VALUES, ids=lambda x: x if isinstance(x, str) else case_id(x))
def test_other_columns_knob_value_matches_jax(monkeypatch, models, columns, kw):
    chars, lengths = corpus("regex3", N, 62)
    got, want = run_both(monkeypatch, *models["regex3"], columns, kw, chars, lengths)
    assert_same(got, want)


@pytest.mark.parametrize("columns", ["full", "match"])
def test_emission_knob_ignored_outside_witness(monkeypatch, models, columns):
    """JAX applies H2R_EMIT only to the witness emission; the port ran no
    columns="full"/"match" matcher under it before (NotImplementedError)."""
    monkeypatch.setenv("H2R_EMIT", "direct")
    chars, lengths = corpus("regex3", N, 63)
    m = T.BitplaneMatcher(models["regex3"][1], columns=columns, device="cpu")
    assert m.plan.emit == "planes"
    monkeypatch.delenv("H2R_EMIT")
    want = as_numpy(T.BitplaneMatcher(models["regex3"][1], columns=columns, device="cpu")(
        chars, lengths))
    assert_same(as_numpy(m(chars, lengths)), want)


def test_post_pallas_is_the_kernel_post(models):
    """``post="pallas"`` (the JAX default, written out) is the fused post
    kernel's name there; the port raised ValueError for it before."""
    chars, lengths = corpus("two_def", N, 64)
    m = T.BitplaneMatcher(models["two_def"][1], columns="witness", post="pallas", device="cpu")
    assert (m.plan.post, m.plan.emit) == ("pallas", "bytes")
    want = T.BitplaneMatcher(models["two_def"][1], columns="witness", post="kernel",
                             device="cpu")(chars, lengths)
    assert_same(as_numpy(m(chars, lengths)), as_numpy(want))
    with pytest.raises(ValueError, match="post="):
        T.BitplaneMatcher(models["two_def"][1], post="mosaic", device="cpu")
