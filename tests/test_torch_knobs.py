"""The port's knob resolution (``halo2_regex_tpu_torch.ops.knobs``) against
the JAX package's, on the same arguments and environments.

The cases of tests/test_knobs.py (defaults, environment, argument
override, the legacy alias, malformed values, explicit conflicts, the
fuse_pack auto-disable) and tests/test_backend_ladder.py's validation:
each resolves to the same knob values, or raises the same error class with
the same words, in both packages; and the port's matcher applies them.
"""

import dataclasses

import pytest

from halo2_regex_tpu.ops.knobs import BitplaneKnobs as JaxKnobs

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs, scan_unroll

from fixtures import CONFIGS

ENV = ("H2R_SCAN_UNROLL", "H2R_FUSE_PACK", "H2R_CLASS_STAGE", "H2R_EN_PACK",
       "H2R_QPACK", "H2R_EMIT", "H2R_WITNESS_BYTES", "H2R_VMEM_LIMIT")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def resolve(pkg_knobs, **kw):
    """The knob values, or (error class, message) of a refusal."""
    try:
        return dataclasses.astuple(pkg_knobs.from_env(**kw))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e), str(e)


def assert_same(**kw):
    want = resolve(JaxKnobs, **kw)
    assert resolve(BitplaneKnobs, **kw) == want
    return want


CASES = [
    # (environment, constructor arguments)
    ({}, {}),
    ({"H2R_SCAN_UNROLL": "4", "H2R_EN_PACK": "1", "H2R_EMIT": "KDECODE",
      "H2R_VMEM_LIMIT": "1048576"}, {}),
    ({"H2R_SCAN_UNROLL": "4", "H2R_FUSE_PACK": "1"}, dict(unroll=2, fuse_pack=False)),
    ({"H2R_WITNESS_BYTES": "0"}, {}),
    ({"H2R_WITNESS_BYTES": "1"}, {}),
    ({"H2R_WITNESS_BYTES": "2"}, {}),
    ({"H2R_EMIT": "fast"}, {}),
    ({"H2R_CLASS_STAGE": "always"}, {}),
    ({"H2R_SCAN_UNROLL": "0"}, {}),
    ({"H2R_VMEM_LIMIT": "-1"}, {}),
    ({"H2R_FUSE_PACK": "1", "H2R_EN_PACK": "1"}, {}),
    ({"H2R_FUSE_PACK": "1", "H2R_QPACK": "1"}, {}),
    ({"H2R_FUSE_PACK": "1", "H2R_CLASS_STAGE": "binary"}, {}),
    ({"H2R_FUSE_PACK": "1"}, {}),
    ({"H2R_CLASS_STAGE": "bogus"}, {}),
    ({"H2R_CLASS_STAGE": "onehot"}, {}),
    ({"H2R_CLASS_STAGE": "1"}, {}),
    ({"H2R_CLASS_STAGE": "FALSE"}, {}),
    ({"H2R_EMIT": "DIRECT"}, {}),
    ({"H2R_EMIT": "dirct"}, {}),
    ({}, dict(class_stage="binary", fuse_pack=True)),
    ({}, dict(class_stage=True)),
    ({}, dict(fuse_pack=True, en_pack=False, qpack=False, class_stage=False)),
    ({}, dict(fuse_pack=True, en_pack=True)),
    ({"H2R_EN_PACK": "0", "H2R_QPACK": "0"}, {}),
    ({"H2R_EMIT": "planes", "H2R_WITNESS_BYTES": "1"}, {}),
    ({}, dict(unroll=-3)),
]


@pytest.mark.parametrize("env,kw", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_knobs_resolve_as_jax(clean_env, env, kw):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert_same(**kw)


def test_defaults_and_refusals_are_the_jax_ones(clean_env):
    assert dataclasses.astuple(BitplaneKnobs.from_env()) == (
        1, False, "binary", True, True, None, 100 * 1024 * 1024)
    clean_env.setenv("H2R_FUSE_PACK", "1")
    k = BitplaneKnobs.from_env()
    assert (k.fuse_pack, k.class_stage, k.en_pack, k.qpack) == (True, False, False, False)
    clean_env.setenv("H2R_EN_PACK", "1")
    with pytest.raises(ValueError, match="conflict"):
        BitplaneKnobs.from_env()


def test_scan_unroll_defaults_to_four(clean_env):
    """The CUDA scans unroll 4 unless the caller gives a factor."""
    assert scan_unroll(BitplaneKnobs.from_env(), None) == 4
    assert scan_unroll(BitplaneKnobs.from_env(unroll=2), 2) == 2
    clean_env.setenv("H2R_SCAN_UNROLL", "1")
    assert scan_unroll(BitplaneKnobs.from_env(), None) == 1


@pytest.fixture(scope="module")
def model():
    return T.CompiledRegexModel.from_decomposed(
        T.DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=32)


def test_matcher_env_validation_as_jax(model, clean_env):
    """tests/test_backend_ladder.py's env_knob_validation, on the port."""
    clean_env.setenv("H2R_CLASS_STAGE", "bogus")
    with pytest.raises(ValueError, match="H2R_CLASS_STAGE"):
        T.BitplaneMatcher(model, device="cpu")
    clean_env.setenv("H2R_CLASS_STAGE", "onehot")
    m = T.BitplaneMatcher(model, device="cpu")
    assert m.knobs.class_stage == "onehot" == m.plan.class_stage
    clean_env.delenv("H2R_CLASS_STAGE")
    clean_env.setenv("H2R_EMIT", "DIRECT")
    m = T.BitplaneMatcher(model, columns="witness", device="cpu")
    assert m.plan.emit == "direct"
    clean_env.setenv("H2R_EMIT", "dirct")
    with pytest.raises(ValueError, match="H2R_EMIT"):
        T.BitplaneMatcher(model, columns="witness", device="cpu")
    clean_env.delenv("H2R_EMIT")
    with pytest.raises(ValueError, match="mutually exclusive"):
        T.BitplaneMatcher(model, class_stage="binary", fuse_pack=True, device="cpu")


@pytest.mark.parametrize("kw,want", [
    (dict(class_stage=False), dict(class_stage=False, kp=8)),
    (dict(class_stage="onehot"), dict(class_stage="onehot")),
    (dict(fuse_pack=True), dict(fuse_pack=True, qpack=False, en_pack=False, class_stage=False)),
    (dict(en_pack=False), dict(en_pack=False)),
    (dict(qpack=False), dict(qpack=False)),
    (dict(emit="kdecode"), dict(emit="kdecode")),
    (dict(post="pallas"), dict(post="pallas", emit="bytes")),
    (dict(post="xla"), dict(post="xla", emit="planes")),
    (dict(unroll=3), dict(unroll=3)),
    ({}, dict(unroll=4, emit="bytes", post="pallas", class_stage="binary")),
])
def test_matcher_plan_follows_knobs(model, clean_env, kw, want):
    plan = T.BitplaneMatcher(model, columns="witness", device="cpu", **kw).plan
    assert {k: getattr(plan, k) for k in want} == want
