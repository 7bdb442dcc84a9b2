"""The knob variants' plain stages against the JAX package's kernels.

Each new plain version of the port is held against the interpret-mode JAX
kernel it stands for, on the same numpy inputs (one seeded 4096-string
batch per model, NWS = 1): the pack kernels (``_make_pack``,
``_make_qpack``, ``_make_tpack``) with the class stage off and one-hot and
with en_pack off; B2's in-scan pack (``_make_scan_fused(fused_pack=
True)``); B7 (``_make_scan`` per def, the ``scan_planes`` hook); B3 in
direct mode and in planes mode under the witness plan; and B14
(``_make_decode``).  Also the JAX pairwise knob matrix
(tests/test_knobs.py) over the port; every knob value end to end is in
tests/test_torch_variants_e2e.py, tests/test_torch_variants_two_def.py
and tests/test_torch_variants_from.py.  The stage tests run here on the
regex3 and two-def models and, in tests/test_torch_variants_from_stages.py,
on the from: model.  Integer outputs: tolerance 0, dtypes included.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher
from halo2_regex_tpu.ops.bitplane import raw_quads as j_raw_quads
from halo2_regex_tpu.ops.bitplane import tile_corpus as j_tile_corpus

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

from test_torch_bitplane import KEYS, MAX_LEN, MODELS, _build, corpus

NB = 4096
NW = NB // 32


def _t(a):
    return torch.from_numpy(np.asarray(a))


def assert_equal(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module")
def models():
    return {n: (_build(J, jzoo, n), _build(T, T.zoo, n)) for n in MODELS}


# (JAX constructor knobs, the port's knobs) of each stage variant
VARIANTS = {
    "off": dict(class_stage=False),
    "off_en": dict(class_stage=False, en_pack=False),
    "onehot": dict(class_stage="onehot"),
    "onehot_en": dict(class_stage="onehot", en_pack=False),
    "fpack": dict(fuse_pack=True),
    "binary": {},
}


def _port_plan(models, name, columns="witness", **kw):
    return bp.make_plan(models[name][1], columns, knobs=BitplaneKnobs.from_env(**kw))


# the models of this module's stage tests; the from: model's run in
# tests/test_torch_variants_from_stages.py, which imports these tests
STAGE_MODELS = ["regex3", "two_def"]


def pytest_generate_tests(metafunc):
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", metafunc.module.STAGE_MODELS)


@pytest.fixture(scope="module")
def jax_variants(request, models):
    """Each of the module's models' JAX kernel outputs under every stage
    variant, on one seeded 4096-string batch, computed once per module."""
    out = {}
    for name in request.module.STAGE_MODELS:
        seed = MODELS.index(name)
        jmodel = models[name][0]
        chars, lengths = corpus(name, NB, 40 + seed)
        len_wb = lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(1, 128, 32)
        R = j_raw_quads(jnp.asarray(chars), MAX_LEN).reshape(MAX_LEN, 8, 1, 128)
        ch_v = jnp.asarray(chars).reshape(8, NW, 4, MAX_LEN)
        s = dict(chars=chars, lengths=lengths, len_wb=len_wb, quads=R)
        for v, kw in VARIANTS.items():
            jm = JaxMatcher(jmodel, columns="witness", interpret=True, **kw)
            if v == "fpack":
                s["fpack_logs"] = jm._make_scan_fused(1, fused_pack=True)(R)
                continue
            if jm._en_in_pack:
                s[f"{v}_bits"], s[f"{v}_en"] = jm._make_qpack(1)(ch_v, jnp.asarray(len_wb))
                if name == "from":  # the raw-quads and tiled packs, one model
                    s[f"{v}_pack"] = jm._make_pack(1)(R, jnp.asarray(len_wb))
                    tl = j_tile_corpus(chars, MAX_LEN)
                    s[f"{v}_tiled"] = tl
                    s[f"{v}_tpack"] = jm._make_tpack(1)(jnp.asarray(tl), jnp.asarray(len_wb))
            else:
                s[f"{v}_bits"] = jm._make_qpack(1)(ch_v)
                if name == "from":
                    s[f"{v}_pack"] = jm._make_pack(1)(R)
            if v in ("off", "binary"):
                s[f"{v}_defs"] = [jm.scan_planes(s[f"{v}_bits"], d) for d in range(jm.n_defs)]
        # the emissions, on the main path's log planes and enable plane
        main = JaxMatcher(jmodel, columns="witness", interpret=True)
        logs = main._make_scan_fused(1)(s["binary_bits"])
        en = s["binary_en"]
        s["logs"], s["en"] = logs, en
        direct = JaxMatcher(jmodel, columns="witness", interpret=True, emit="direct")
        assert direct._emit == "direct"
        s["direct"] = direct._make_post(1)(logs, en[:, None])
        planes = JaxMatcher(jmodel, columns="witness", interpret=True, emit="planes")
        assert planes._emit == "planes"
        s["wplanes"] = planes._make_post(1)(logs, en[:, None])
        kd = JaxMatcher(jmodel, columns="witness", interpret=True, emit="kdecode")
        g4, _fb = kd._make_post(1)(logs, en[:, None])
        ch_l4 = jnp.asarray(chars).reshape(NB, MAX_LEN // 4, 4).view(jnp.int32)[..., 0]
        s["g4"], s["ch_l4"] = g4, ch_l4
        s["decode"] = kd._make_decode(1)(g4.reshape(1, len(kd._wgroups), 8, MAX_LEN, 128), ch_l4)
        out[name] = {k: ([np.asarray(x) for x in v] if isinstance(v, (list, tuple))
                         else np.asarray(v)) for k, v in s.items()}
    return out


@pytest.mark.parametrize("variant", ["off", "off_en", "onehot", "onehot_en"])
def test_pack_modes_match_jax(models, jax_variants, name, variant):
    """qpack (and, on the from: model, the raw-quads and tiled packs) with
    the class stage off or one-hot, en_pack on and off."""
    s = jax_variants[name]
    plan = _port_plan(models, name, **VARIANTS[variant])
    if not plan.class_stage:
        assert plan.kp == 8
    lw = _t(s["len_wb"])
    bits, en = bp.qpack_plain(plan, _t(s["chars"]), lw)
    assert_equal(bits, s[f"{variant}_bits"], "bits")
    if variant.endswith("_en"):
        assert en is None
    else:
        assert_equal(en, s[f"{variant}_en"], "en")
    if name == "from":
        bits, en = bp.pack_plain(plan, _t(s["quads"]), lw)
        want = s[f"{variant}_pack"]
        if variant.endswith("_en"):
            assert_equal(bits, want, "pack bits")
            assert en is None
        else:
            assert_equal(bits, want[0], "pack bits")
            assert_equal(en, want[1], "pack en")
            tplan = bp.make_plan(models[name][1], "witness", tiled=True,
                                 knobs=BitplaneKnobs.from_env(**VARIANTS[variant]))
            tb, te = bp.tpack_plain(tplan, _t(s[f"{variant}_tiled"]), lw)
            assert_equal(tb, s[f"{variant}_tpack"][0], "tpack bits")
            assert_equal(te, s[f"{variant}_tpack"][1], "tpack en")


def test_enable_plane_matches_jax(models, jax_variants, name):
    """The torch enable plane (en_pack off) is the pack kernel's."""
    s = jax_variants[name]
    assert_equal(bp.enable_plane(_t(s["len_wb"]), MAX_LEN), s["binary_en"], "en")


def test_scan_fpack_plain_matches_jax(models, jax_variants, name):
    """B2 with fused_pack: the raw quad rows in, the folded-class step
    circuits; equal to the JAX kernel and to the class-off scan."""
    s = jax_variants[name]
    plan = _port_plan(models, name, fuse_pack=True)
    assert plan.fuse_pack and not plan.class_stage and not plan.qpack
    logs = bp.scan_fpack_plain(plan, _t(s["quads"]))
    assert_equal(logs, s["fpack_logs"], "logs")
    assert_equal(bp.scan_plain(plan, _t(s["off_bits"])), s["fpack_logs"], "class-off scan")


@pytest.mark.parametrize("variant", ["off", "binary"])
def test_scan_def_plain_matches_jax(models, jax_variants, name, variant):
    """B7 per def (the scan_planes hook) on the binary class planes and on
    the byte planes (class stage off), through the matcher's method."""
    s = jax_variants[name]
    m = T.BitplaneMatcher(models[name][1], columns="witness", device="cpu",
                          **VARIANTS[variant])
    for d, want in enumerate(s[f"{variant}_defs"]):
        assert_equal(m.scan_planes(s[f"{variant}_bits"], d), want, f"def {d}")
    with pytest.raises(ValueError, match="defs"):
        m.scan_planes(s[f"{variant}_bits"], m.plan.n_defs)


def test_post_direct_plain_matches_jax(models, jax_variants, name):
    """B3's direct mode: one l4-packed string-major array per field."""
    s = jax_variants[name]
    plan = _port_plan(models, name, emit="direct")
    out = bp.post_direct_plain(plan, _t(s["logs"]), _t(s["en"]))
    assert out.shape[0] == len(s["direct"]) == len(plan.dfields)
    for fi, want in enumerate(s["direct"]):
        assert_equal(out[fi], want, plan.dfields[fi][0])


def test_post_planes_witness_plain_matches_jax(models, jax_variants, name):
    """B3's planes mode under the witness plan (masked_idsum, fwd, bwd,
    mask, start_any, endf_any)."""
    s = jax_variants[name]
    plan = _port_plan(models, name, emit="planes")
    assert list(plan.post_off) == ["masked_idsum", "fwd", "bwd", "mask", "start_any", "endf_any"]
    assert_equal(bp.post_planes_plain(plan, _t(s["logs"]), _t(s["en"])), s["wplanes"], "planes")


def test_decode_plain_matches_jax(models, jax_variants, name):
    """B14 on the bytes-mode post's words: every field and the masked
    characters."""
    s = jax_variants[name]
    plan = _port_plan(models, name, emit="kdecode")
    out = bp.decode_plain(plan, _t(s["g4"]), _t(s["ch_l4"]))
    assert out.shape[0] == len(s["decode"]) == len(plan.fields_flat) + 1
    for fi, want in enumerate(s["decode"]):
        assert_equal(out[fi], want, f"output {fi}")
    assert (s["decode"][-1] != 0).any()  # some characters are masked in


# ---------------------------------------------------------------------------
# end to end: the pairwise knob matrix
# ---------------------------------------------------------------------------


def _jax_witness(m, chars, lengths):
    return {k: np.asarray(v) for k, v in m(chars, lengths).items()}


def assert_witness(got, want):
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        assert_equal(got[k], want[k], k)


# tests/test_knobs.py's pairwise matrix over the port: every pair of
# non-default knob values gives the JAX default matcher's witness output
KNOB_VALUES = {
    "H2R_EMIT": [None, "kdecode", "planes"],
    "H2R_EN_PACK": [None, "1"],
    "H2R_QPACK": [None, "1"],
    "H2R_SCAN_UNROLL": [None, "4"],
    "H2R_CLASS_STAGE": [None, "0"],
}
_PAIRS = [((a, va), (b, vb)) for a, b in itertools.combinations(KNOB_VALUES, 2)
          for va in KNOB_VALUES[a][1:] for vb in KNOB_VALUES[b][1:]]


@pytest.fixture(scope="module")
def pair_inputs():
    rng = np.random.default_rng(42)
    chars = rng.integers(0, 256, size=(NB, MAX_LEN)).astype(np.uint8)
    lengths = rng.integers(0, MAX_LEN + 1, size=(NB,)).astype(np.int32)
    lengths[0], lengths[1] = 0, MAX_LEN
    return chars, lengths


@pytest.fixture(scope="module")
def pair_baseline(models, pair_inputs):
    with pytest.MonkeyPatch.context() as mp:
        for k in KNOB_VALUES:
            mp.delenv(k, raising=False)
        jm = JaxMatcher(models["regex3"][0], columns="witness", interpret=True)
        return _jax_witness(jm, *pair_inputs)


@pytest.mark.parametrize("pair", _PAIRS, ids=lambda p: f"{p[0][0]}={p[0][1]}/{p[1][0]}={p[1][1]}")
def test_pairwise_knobs_match_jax(monkeypatch, models, pair_inputs, pair_baseline, pair):
    for k in KNOB_VALUES:
        monkeypatch.delenv(k, raising=False)
    for k, v in pair:
        monkeypatch.setenv(k, v)
    got = T.BitplaneMatcher(models["regex3"][1], columns="witness", device="cpu")(*pair_inputs)
    assert_witness(got, pair_baseline)
