"""The pack and scan knob values end to end on the zk-email from: model at
L=64, against the JAX matcher with the same knobs (see
tests/test_torch_variants_e2e.py).  Tolerance 0, dtypes included."""

import pytest

from test_torch_variants_e2e import PACK_VALUES, case_id
from test_torch_variants_from import from_models  # noqa: F401  (the module-scoped fixture)
from test_torch_variants_from import check_from_value


@pytest.mark.parametrize("kw", PACK_VALUES, ids=case_id)
def test_from_witness_pack_knob_value_matches_jax(monkeypatch, from_models, kw):
    check_from_value(monkeypatch, from_models, kw)
