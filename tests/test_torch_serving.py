"""The PyTorch port's serving paths against the JAX package.

``columns="match"`` (corpus filtering), ``columns="full"`` (the whole
``RegexResult``, the JAX default), any L through the raw-quads pack, and
``extract_runs``.  Each new stage's plain version (``post_planes_plain``,
``fb_only_plain``, ``pack_plain``) is held against the JAX kernel it
stands for, run in Pallas interpret mode on the same seeded numpy inputs
(NWS = 1: 4096 strings); the end-to-end outputs are held against the JAX
``BitplaneMatcher`` and the numpy oracle.  All outputs are integers or
booleans: tolerance 0, dtypes included.  The CUDA kernels are held
against these same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops import bitplane as jbp
from halo2_regex_tpu.ops import extract as jex
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops.reference import extract_substrings, match_substrs

from test_torch_bitplane import MAX_LEN, MODELS, STRINGS3, STRINGS12, _build, _pack, corpus

L200 = 200  # L > 128, not a multiple of 128: L_pad 256, qpack off
FIELDS = T.RegexResult.field_names()


@pytest.fixture(scope="module")
def models():
    return {n: (_build(J, jzoo, n), _build(T, T.zoo, n)) for n in MODELS}


@pytest.fixture(scope="module")
def models200():
    return {n: (_build(J, jzoo, n, L200), _build(T, T.zoo, n, L200)) for n in MODELS}


def _len_wb(lengths):
    NW = lengths.shape[0] // 32
    return lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(NW // 128, 128, 32)


@pytest.fixture(scope="module")
def jax_full_stages(models):
    """Each model's JAX kernel intermediates of a ``columns="full"``
    matcher (planes-mode post, and the fb-only kernel) on one seeded
    4096-string batch, computed once per module."""
    out = {}
    for seed, n in enumerate(MODELS):
        jm = JaxMatcher(models[n][0], interpret=True)
        chars, lengths = corpus(n, 4096, seed)
        len_wb = _len_wb(lengths)
        bits, en = jm._make_qpack(1)(
            jnp.asarray(chars).reshape(8, 4096 // 32, 4, MAX_LEN), jnp.asarray(len_wb)
        )
        logs = jm._make_scan_fused(1)(bits)
        planes = jm._make_post(1)(logs, en[:, None])
        fb = jm._make_fb_only(1)(logs, en[:, None])
        out[n] = {k: np.array(v) for k, v in dict(
            logs=logs, en=en, planes=planes, fb=fb,
            final=jm._final_from_fb(fb, 4096)).items()}
    return out


def assert_equal(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def assert_result_equal(got, want):
    assert isinstance(got, T.RegexResult), type(got)
    for k in FIELDS:
        assert_equal(getattr(got, k), getattr(want, k), k)


def assert_dict_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert_equal(got[k], want[k], k)


# ---------------------------------------------------------------------------
# stage by stage: plain version vs the JAX kernel on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_post_planes_plain_matches_jax(models, jax_full_stages, name):
    s = jax_full_stages[name]
    plan = bp.make_plan(models[name][1], "full")
    planes = bp.post_planes_plain(plan, torch.from_numpy(s["logs"]), torch.from_numpy(s["en"]))
    assert_equal(planes, s["planes"], "post planes")
    assert (planes[:, plan.post_off["mask"][0]] != 0).any()


@pytest.mark.parametrize("name", MODELS)
def test_fb_only_plain_matches_jax(models, jax_full_stages, name):
    s = jax_full_stages[name]
    plan = bp.make_plan(models[name][1], "match")
    fb = bp.fb_only_plain(plan, torch.from_numpy(s["logs"]), torch.from_numpy(s["en"]))
    assert_equal(fb, s["fb"], "fb")
    # the boundary decode keeps JAX's int32 (torch's sum would widen it)
    assert_equal(bp.final_from_fb(fb, 4096), s["final"], "final states")


@pytest.mark.parametrize("name", MODELS)
def test_pack_plain_matches_jax(models200, name):
    """B5 at L=200 (L_pad 256): raw quad rows and the pack kernel's class
    and enable planes."""
    jm = JaxMatcher(models200[name][0], columns="match", interpret=True)
    plan = bp.make_plan(models200[name][1], "match")
    assert (jm.L_pad, jm._qpack) == (plan.L_pad, plan.qpack) == (256, False)
    chars, lengths = corpus(name, 4096, 5, L=L200)
    want_q = jbp.raw_quads(jnp.asarray(chars), 256).reshape(256, 8, 1, 128)
    want_bits, want_en = jm._make_pack(1)(want_q, jnp.asarray(_len_wb(lengths)))
    quads = bp.raw_quads(torch.from_numpy(chars), plan.L_pad)
    assert_equal(quads, want_q, "raw quads")
    bits, en = bp.pack_plain(plan, quads, bp.len_table(torch.from_numpy(lengths)))
    assert_equal(bits, want_bits, "bits_stack")
    assert_equal(en, want_en, "en_plane")


@pytest.mark.parametrize("name", ["regex3", "two_def", "from"])
def test_make_plan_layout_matches_jax(models200, name):
    jm = JaxMatcher(models200[name][0], interpret=True)
    plan = bp.make_plan(models200[name][1], "full")
    assert plan.post_off == jm._post_off and plan.p_total == jm._p_total
    assert (plan.L_pad, plan.nsum, plan.sb_sum) == (jm.L_pad, jm.nsum, jm._sb_sum)


def test_unpack_groups_matches_jax():
    """Grouped plane -> value decode, L sliced from L_pad, with a field
    wider than 8 planes (int32 values, as in JAX)."""
    rng = np.random.default_rng(11)
    sizes = [("a", 1), ("b", 5), ("c", 3), ("wide", 10), ("d", 2)]
    named = [(n, [rng.integers(-2**31, 2**31, (1, 128, 128), dtype=np.int64).astype(np.int32)
                  for _ in range(nb)]) for n, nb in sizes]
    want = jbp.unpack_groups([(n, [jnp.asarray(p) for p in ps]) for n, ps in named], 100)
    got = bp.unpack_groups([(n, [torch.from_numpy(p) for p in ps]) for n, ps in named], 100)
    assert set(got) == set(want)
    for n, _nb in sizes:
        assert_equal(got[n], want[n], n)


# ---------------------------------------------------------------------------
# end to end: match dict and RegexResult vs the JAX matcher and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_match_matches_jax(models, name):
    """4096 + 3 strings pad to NWS = 2 and the verdicts slice back."""
    chars, lengths = corpus(name, 4099, 42)
    out = T.BitplaneMatcher(models[name][1], columns="match", device="cpu")(chars, lengths)
    want = JaxMatcher(models[name][0], columns="match", interpret=True)(chars, lengths)
    assert set(out) == {"final_states", "accepted", "has_dead", "match_ok"}
    assert out["final_states"].shape == (4099, models[name][1].n_defs)
    assert_dict_equal(out, want)
    assert out["accepted"].any() and out["has_dead"].any()


@pytest.mark.parametrize("name,compact", [
    ("regex3", True), ("regex3", False), ("two_def", True), ("from", True),
])
def test_full_matches_jax(models, name, compact):
    chars, lengths = corpus(name, 4099, 43)
    got = T.BitplaneMatcher(models[name][1], compact=compact, device="cpu")(chars, lengths)
    want = JaxMatcher(models[name][0], compact=compact, interpret=True)(chars, lengths)
    assert got.states.shape == (4099, models[name][1].n_defs, MAX_LEN + 1)
    assert_result_equal(got, want)


@pytest.mark.parametrize("columns", ["full", "witness", "match"])
def test_columns_at_unpadded_length_match_jax(models200, columns):
    """L=200: every column set packs through B5 and slices L_pad back."""
    chars, lengths = corpus("regex3", 300, 44, L=L200)
    m = T.BitplaneMatcher(models200["regex3"][1], columns=columns, device="cpu")
    assert not m.plan.qpack
    got = m(chars, lengths)
    want = JaxMatcher(models200["regex3"][0], columns=columns, interpret=True)(chars, lengths)
    if columns == "full":
        assert_result_equal(got, want)
        assert got.match_ok.any()
    else:
        assert_dict_equal(got, want)


@pytest.mark.parametrize("name,strings", [("regex3", STRINGS3), ("two_def", STRINGS12)])
def test_full_matches_oracle(models, name, strings):
    chars, lengths = _pack(strings)
    res = T.BitplaneMatcher(models[name][1], device="cpu")(chars, lengths)
    for i, s in enumerate(strings):
        o = match_substrs(models[name][1].regex_defs, s, MAX_LEN)
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(res, k)[i].numpy().astype(np.int64),
                np.asarray(getattr(o, k)).astype(np.int64), err_msg=f"string {i} {k}")


def test_default_columns_is_full(models):
    """``BitplaneMatcher(model)`` returns a ``RegexResult``, as the JAX
    package's default does, and ``match_one`` maps it to row 0."""
    chars, lengths = _pack(STRINGS3)
    m = T.BitplaneMatcher(models["regex3"][1], device="cpu")
    assert m.columns == "full"
    assert_result_equal(m(chars, lengths), JaxMatcher(models["regex3"][0], interpret=True)(chars, lengths))
    one = m.match_one(STRINGS3[0])
    assert isinstance(one, T.RegexResult) and bool(one.match_ok)
    assert one.states.shape == (1, MAX_LEN + 1)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_qpack_off_runs_raw_quads_pack(models, monkeypatch, how):
    """qpack=False (or H2R_QPACK=0) packs through B5 at L == L_pad, with
    the same result as the qpack route."""
    chars, lengths = corpus("two_def", 200, 45)
    if how == "environment":
        monkeypatch.setenv("H2R_QPACK", "0")
        m = T.BitplaneMatcher(models["two_def"][1], device="cpu")
    else:
        m = T.BitplaneMatcher(models["two_def"][1], qpack=False, device="cpu")
    assert not m.plan.qpack
    monkeypatch.delenv("H2R_QPACK", raising=False)
    base = T.BitplaneMatcher(models["two_def"][1], device="cpu")
    assert base.plan.qpack
    want = base(chars, lengths)
    assert_result_equal(m(chars, lengths), want.map(lambda v: v.numpy()))


# ---------------------------------------------------------------------------
# extraction serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_two_def(models):
    chars, lengths = corpus("two_def", 600, 46)
    return T.BitplaneMatcher(models["two_def"][1], device="cpu")(chars, lengths)


@pytest.mark.parametrize("max_len", [32, 0])
def test_extract_runs_matches_jax(full_two_def, max_len):
    ids = full_two_def.all_substr_ids.clone()
    chars = full_two_def.masked_characters.clone()
    # one row with more runs than max_runs: n_runs flags the overflow
    ids[0] = 0
    ids[0, [1, 4, 7, 9, 12, 14]] = 1
    chars[0] = ids[0] * 65
    got = T.extract_runs(ids, chars, max_runs=4, max_len=max_len)
    want = jex.extract_runs(jnp.asarray(ids.numpy()), jnp.asarray(chars.numpy()),
                            max_runs=4, max_len=max_len)
    assert_dict_equal(got, want)
    assert int(got["n_runs"][0]) == 6 and (got["n_runs"] > 0).sum() > 10
    # rows narrower than max_runs
    ids3 = torch.tensor([[1, 2, 0], [0, 3, 3], [4, 0, 4], [0, 0, 0]], dtype=torch.int32)
    got = T.extract_runs(ids3, ids3 * 7, max_runs=4, max_len=max_len)
    want = jex.extract_runs(jnp.asarray(ids3.numpy()), jnp.asarray(ids3.numpy() * 7),
                            max_runs=4, max_len=max_len)
    assert_dict_equal(got, want)


def test_runs_to_python_matches_extract_substrings(full_two_def):
    out = T.extract_runs(full_two_def.all_substr_ids, full_two_def.masked_characters,
                         max_runs=4, max_len=32)
    n = 0
    for i in range(full_two_def.match_ok.shape[0]):
        row = full_two_def.map(lambda v, i=i: v[i].numpy())
        want = extract_substrings(row)
        if len(want) <= 4:
            assert T.runs_to_python(out, i) == want, i
            n += bool(want)
    assert n > 10
