"""The pack and scan knob values end to end on the two-def model at L=64,
against the JAX matcher with the same knobs (see
tests/test_torch_variants_e2e.py).  Tolerance 0, dtypes included."""

import pytest

from test_torch_variants_e2e import models  # noqa: F401  (the module-scoped fixture)
from test_torch_variants_e2e import PACK_VALUES, case_id, check_witness_value


@pytest.mark.parametrize("kw", PACK_VALUES, ids=case_id)
def test_two_def_witness_pack_knob_value_matches_jax(monkeypatch, models, kw):
    check_witness_value(monkeypatch, models, "two_def", kw)
