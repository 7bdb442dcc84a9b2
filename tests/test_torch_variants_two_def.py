"""Every witness emission knob value end to end on the two-def model at
L=64 (the pack and scan knobs: tests/test_torch_variants_two_def_pack.py), and
a 4099-string batch that pads inside the pipeline, against the JAX
matcher with the same knobs (see tests/test_torch_variants_e2e.py).
Tolerance 0, dtypes included."""

import pytest

from test_torch_bitplane import corpus
from test_torch_variants_e2e import models  # noqa: F401  (the module-scoped fixture)
from test_torch_variants_e2e import (EMIT_VALUES, assert_same, case_id, check_witness_value,
                                     run_both)


@pytest.mark.parametrize("kw", EMIT_VALUES, ids=case_id)
def test_two_def_witness_knob_value_matches_jax(monkeypatch, models, kw):
    check_witness_value(monkeypatch, models, "two_def", kw)


@pytest.mark.parametrize("kw", [dict(emit="direct"), dict(emit="kdecode", fuse_pack=True)],
                         ids=case_id)
def test_variants_pad_4099(monkeypatch, models, kw):
    """4096 + 3 strings pad to NWS = 2 inside the pipeline; the direct and
    kdecode emissions (and the in-scan pack) slice back to 4099."""
    chars, lengths = corpus("regex3", 4099, 42)
    got, want = run_both(monkeypatch, *models["regex3"], "witness", kw, chars, lengths)
    assert got["states"].shape == (4099, 1, chars.shape[1] + 1)
    assert_same(got, want)
