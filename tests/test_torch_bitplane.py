"""The PyTorch port's bitplane witness pipeline against the JAX package.

Each stage's plain PyTorch version (``qpack_plain``, ``scan_plain``,
``post_plain``) is held against the JAX kernel it stands for, run in
Pallas interpret mode on the same numpy inputs; the whole witness dict is
held against the JAX ``BitplaneMatcher(columns="witness")`` and the
numpy oracle.  All outputs are integers or booleans: tolerance 0.
The CUDA kernels are held against these same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops.reference import match_substrs

from fixtures import CONFIGS

MAX_LEN = 64
KEYS = ("states", "all_substr_ids", "masked_characters", "flags", "mask",
        "accepted", "has_dead", "match_ok")
MODELS = ["regex3", "two_def", "from"]

STRINGS3 = [
    b"from:alice@gmail.com\r\n",
    b"dummy\r\nfrom:alice<alice@gmail.com>\r\n",
    b"from:alice<alicegmail.com>\r\n",
    b"",
    bytes([0, 1, 2]),
    b"from:bob@x.yz\r\n",
    b"from:alice<alice@gmail.com>",
    b"x" * MAX_LEN,  # full-length input
]
STRINGS12 = [
    b"email was meant for @y. Also for x.",
    b"email was meant for @yajk. Also for swq.",
    b"email was meant for @@",
    b"",
]
PIECES = {
    "regex3": [b"from:", b"@", b".", b"<", b">", b"\r\n", b"ab", b"x.y", b"gmail.com"],
    "from": [b"from:", b"@", b".", b"<", b">", b"\r\n", b"ab", b"x.y", b"gmail.com"],
    "two_def": [b"email was meant for @", b" Also for ", b"abc", b"xy", b".", b"@"],
}


def _build(pkg, zoo, name, L=MAX_LEN):
    if name == "from":
        return zoo.email_headers_model(max_chars_size=L, headers=("from",))
    cfgs = (["regex1", "regex2"] if name == "two_def" else [name])
    return pkg.CompiledRegexModel.from_decomposed(
        [pkg.DecomposedRegexConfig.from_json(CONFIGS[c]) for c in cfgs],
        max_chars_size=L,
    )


def corpus(name, n, seed, L=MAX_LEN):
    """Seeded strings built from pieces of the model's language (so the
    masks and ids light up), with every 7th string random bytes."""
    rng = np.random.default_rng(seed)
    chars = np.zeros((n, L), np.uint8)
    lengths = np.zeros((n,), np.int32)
    pieces = PIECES[name]
    for i in range(n):
        if i % 7 == 3:
            s = rng.integers(0, 256, size=int(rng.integers(0, L + 1))).astype(np.uint8).tobytes()
        elif i % 3 == 1 and name != "two_def":
            user = bytes(rng.choice(list(b"abcxyz._-"), size=int(rng.integers(1, 8))).astype(np.uint8))
            s = (b"ab c" * int(rng.integers(0, 3)) + b"\r\nfrom:"
                 + (b"Al <" if i % 2 else b"") + user + b"@gmail.com"
                 + (b">" if i % 2 else b"") + b"\r\n")
        else:
            k = int(rng.integers(0, 8))
            s = b"".join(pieces[j] for j in rng.integers(0, len(pieces), size=k))
        s = s[:L]
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.fixture(scope="module")
def models():
    return {n: (_build(J, jzoo, n), _build(T, T.zoo, n)) for n in MODELS}


@pytest.fixture(scope="module")
def jax_matchers(models):
    return {n: JaxMatcher(models[n][0], columns="witness", interpret=True) for n in MODELS}


@pytest.fixture(scope="module")
def ports(models):
    return {n: T.BitplaneMatcher(models[n][1], columns="witness", device="cpu") for n in MODELS}


@pytest.fixture(scope="module")
def jax_stages(models, jax_matchers):
    """Each model's JAX kernel intermediates on one seeded 4096-string
    batch (NWS = 1), computed once per module."""
    out = {}
    for seed, n in enumerate(MODELS):
        jm = jax_matchers[n]
        chars, lengths = corpus(n, 4096, seed)
        NW = 4096 // 32
        len_wb = lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(1, 128, 32)
        bits, en = jm._make_qpack(1)(
            jnp.asarray(chars).reshape(8, NW, 4, MAX_LEN), jnp.asarray(len_wb)
        )
        logs = jm._make_scan_fused(1)(bits)
        g4, fb = jm._make_post(1)(logs, en[:, None])
        out[n] = {k: np.array(v) for k, v in dict(
            chars=chars, lengths=lengths, len_wb=len_wb, bits=bits, en=en,
            logs=logs, g4=g4, fb=fb).items()}
    return out


def assert_equal(got: torch.Tensor, want, what):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# stage by stage: plain version vs the JAX kernel on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MODELS)
def test_qpack_plain_matches_jax(ports, jax_stages, name):
    s = jax_stages[name]
    bits, en = bp.qpack_plain(
        ports[name].plan, torch.from_numpy(s["chars"]), torch.from_numpy(s["len_wb"])
    )
    assert_equal(bits, s["bits"], "bits_stack")
    assert_equal(en, s["en"], "en_plane")


@pytest.mark.parametrize("name", MODELS)
def test_scan_plain_matches_jax(ports, jax_stages, name):
    s = jax_stages[name]
    logs = bp.scan_plain(ports[name].plan, torch.from_numpy(s["bits"]))
    assert_equal(logs, s["logs"], "logs_stack")


@pytest.mark.parametrize("name", MODELS)
def test_post_plain_matches_jax(ports, jax_stages, name):
    s = jax_stages[name]
    g4, fb = bp.post_plain(
        ports[name].plan, torch.from_numpy(s["logs"]), torch.from_numpy(s["en"])
    )
    assert_equal(g4, s["g4"], "g4")
    assert_equal(fb, s["fb"], "fb")


@pytest.mark.parametrize("name", MODELS)
def test_stages_light_up(jax_stages, name):
    """The stage inputs exercise the interesting paths: some strings
    match (mask bits set) and some carry ids."""
    s = jax_stages[name]
    assert s["chars"].any() and (s["lengths"] == 0).any()
    flags0 = s["g4"][:, 0]  # byte-group word with flags bit 0 = mask
    assert (flags0 & 0x01010101).any()


# ---------------------------------------------------------------------------
# end to end: the witness dict vs the JAX matcher and the oracle
# ---------------------------------------------------------------------------


def assert_witness_equal(got, want):
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        assert_equal(got[k], want[k], k)


def assert_oracle(model, out, strings):
    for i, s in enumerate(strings):
        o = match_substrs(model.regex_defs, s, MAX_LEN)
        for key, want in (("states", o.states), ("all_substr_ids", o.all_substr_ids),
                          ("masked_characters", o.masked_characters),
                          ("mask", o.mask), ("match_ok", o.match_ok),
                          ("accepted", o.accepted), ("has_dead", o.has_dead)):
            np.testing.assert_array_equal(
                out[key][i].numpy().astype(np.int64),
                np.asarray(want).astype(np.int64), err_msg=f"string {i} {key}",
            )


def _pack(strings):
    chars = np.zeros((len(strings), MAX_LEN), np.uint8)
    lengths = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        chars[i, : len(s)] = bytearray(s)
        lengths[i] = len(s)
    return chars, lengths


@pytest.mark.parametrize("name,strings", [("regex3", STRINGS3), ("two_def", STRINGS12)])
def test_witness_matches_jax_and_oracle(models, jax_matchers, ports, name, strings):
    chars, lengths = _pack(strings)
    out = ports[name](chars, lengths)
    assert_witness_equal(out, jax_matchers[name](chars, lengths))
    assert_oracle(models[name][1], out, strings)


def test_witness_fuzz_4099_pads_and_slices(jax_matchers, ports):
    """4096 + 3 strings pad to NWS = 2 inside the pipeline and the outputs
    are sliced back to 4099."""
    chars, lengths = corpus("regex3", 4099, 42)
    out = ports["regex3"](chars, lengths)
    assert out["states"].shape == (4099, 1, MAX_LEN + 1)
    assert_witness_equal(out, jax_matchers["regex3"](chars, lengths))
    assert int(out["match_ok"].sum()) > 100


def test_witness_from_model_oracle(models, ports):
    chars, lengths = corpus("from", 96, 7)
    out = ports["from"](chars, lengths)
    strings = [bytes(chars[i, : lengths[i]]) for i in range(len(lengths))]
    assert_oracle(models["from"][1], out, strings)
    assert out["match_ok"].any()


@pytest.mark.parametrize("L", [1, 3, 33])
def test_witness_short_models_oracle(L):
    """Models with few positions (L below the 4-byte and 32-position
    groupings of the layout) against the numpy oracle."""
    model = T.CompiledRegexModel.from_decomposed(
        T.DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=L
    )
    strings = [s[:L] for s in (b"", b"f", b"fr", b"fro", b"from:a@b\r\n", b"\xff" * L)]
    chars = np.zeros((len(strings), L), np.uint8)
    lengths = np.array([len(s) for s in strings], np.int32)
    for i, s in enumerate(strings):
        chars[i, : len(s)] = bytearray(s)
    out = T.BitplaneMatcher(model, columns="witness", device="cpu")(chars, lengths)
    for i, s in enumerate(strings):
        o = match_substrs(model.regex_defs, s, L)
        np.testing.assert_array_equal(out["states"][i].numpy(), o.states)
        np.testing.assert_array_equal(out["mask"][i].numpy(), o.mask)
        assert bool(out["match_ok"][i]) == bool(o.match_ok)


def test_witness_plain_flag_is_the_cpu_route(ports):
    chars, lengths = corpus("from", 40, 9)
    m = ports["from"]
    a = m(chars, lengths)
    b = bp.run(m.plan, m.tables(), torch.from_numpy(chars), torch.from_numpy(lengths),
               plain=True)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# what the port refuses, and the settings it once refused
# ---------------------------------------------------------------------------


def test_cuda_device_without_cuda_raises(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.BitplaneMatcher(models["regex3"][1], columns="witness", device="cuda")


def test_stage_on_unsupported_device_raises(ports):
    x = torch.empty((4096, MAX_LEN), dtype=torch.uint8, device="meta")
    lw = torch.empty((1, 128, 32), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu .plain. or cuda"):
        bp.qpack(ports["regex3"].plan, x, lw)


@pytest.fixture(scope="module")
def jax_strings3(jax_matchers):
    """The JAX default witness matcher's output on STRINGS3, computed once."""
    chars, lengths = _pack(STRINGS3)
    return {k: np.asarray(v) for k, v in jax_matchers["regex3"](chars, lengths).items()}


def assert_resolves_and_runs_as_jax(models, jax_strings3, **kw):
    """The port's matcher under ``kw`` (and the caller's environment)
    resolves its knobs as the JAX matcher does under the same settings,
    and returns the JAX witness dict on STRINGS3: every knob value of the
    JAX matcher gives the default's outputs (tests/test_torch_variants_*.py
    hold each value against the JAX matcher run with it)."""
    m = T.BitplaneMatcher(models["regex3"][1], columns="witness", device="cpu", **kw)
    j = JaxMatcher(models["regex3"][0], columns="witness", interpret=True, **kw)  # not called
    assert (m.plan.emit, m.plan.class_stage, m.plan.fuse_pack, m.plan.kp, m.plan.en_pack,
            m.plan.qpack) == (j._emit, j.class_stage, j.fuse_pack, j._kp, j._en_in_pack, j._qpack)
    assert_witness_equal(m(*_pack(STRINGS3)), jax_strings3)


@pytest.mark.parametrize("kw", [
    dict(emit="planes"), dict(fuse_pack=True), dict(input_layout="tiled"),
    dict(post="xla"), dict(emit="kdecode"), dict(en_pack=False),
    dict(class_stage="onehot"), dict(unroll=4),
])
def test_unported_settings_raise(models, jax_strings3, kw):
    """The settings the port once refused run now, as in the JAX matcher
    (the name is kept from when they raised).  The tiled input contract
    runs with the tiled pack and post (tests/test_torch_tiled.py holds it
    to the JAX package)."""
    if "input_layout" in kw:
        m = T.BitplaneMatcher(models["regex3"][1], columns="witness", device="cpu", **kw)
        assert m.plan.tiled and not m.plan.qpack and m.input_layout == "tiled"
        out = m.match_one(b"from:alice@gmail.com\r\n")
        assert bool(out["match_ok"])
        return
    assert_resolves_and_runs_as_jax(models, jax_strings3, **kw)


def test_unpadded_length_raises():
    """L > 128 with L % 128 != 0 no longer raises: the plan pads L to
    L_pad as the JAX matcher does, and packs through the raw-quads pack
    (B5), since qpack needs L == L_pad."""
    model = T.CompiledRegexModel.from_decomposed(
        T.DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=200
    )
    plan = T.BitplaneMatcher(model, columns="witness", device="cpu").plan
    assert (plan.L, plan.L_pad, plan.qpack) == (200, 256, False)


@pytest.mark.parametrize("var,value", [
    ("H2R_EMIT", "direct"), ("H2R_EMIT", "planes"), ("H2R_WITNESS_BYTES", "0"),
    ("H2R_CLASS_STAGE", "onehot"), ("H2R_SCAN_UNROLL", "2"), ("H2R_FUSE_PACK", "1"),
    ("H2R_EN_PACK", "0"),
])
def test_unported_env_knobs_raise(models, jax_strings3, monkeypatch, var, value):
    """The environment knobs the port once refused run now, resolved as
    in the JAX matcher (the name is kept from when they raised)."""
    monkeypatch.setenv(var, value)
    assert_resolves_and_runs_as_jax(models, jax_strings3)


def test_main_path_knobs_accepted(models, monkeypatch):
    """The main path's own settings, as arguments or in the environment,
    and an argument that overrides a refused environment value."""
    for var, value in (("H2R_QPACK", "1"), ("H2R_EMIT", "BYTES"),
                       ("H2R_CLASS_STAGE", "binary"), ("H2R_EN_PACK", "0")):
        monkeypatch.setenv(var, value)
    m = T.BitplaneMatcher(models["regex3"][1], qpack=True, emit="bytes",
                          class_stage="binary", en_pack=True, unroll=1,
                          fuse_pack=False, device="cpu")
    assert m.plan.L == MAX_LEN


def test_default_columns_is_witness(models, ports):
    """``columns="witness"`` is no longer the default (the JAX default,
    "full", is; tests/test_torch_serving.py holds that): given
    explicitly it returns the witness dict."""
    chars, lengths = _pack(STRINGS3)
    m = T.BitplaneMatcher(models["regex3"][1], columns="witness", device="cpu")
    assert T.BitplaneMatcher(models["regex3"][1], device="cpu").columns == "full"
    assert_witness_equal(m(chars, lengths),
                         {k: v.numpy() for k, v in ports["regex3"](chars, lengths).items()})


def test_multiple_of_128_length_plans():
    model = T.CompiledRegexModel.from_decomposed(
        T.DecomposedRegexConfig.from_json(CONFIGS["regex3"]), max_chars_size=256
    )
    assert T.BitplaneMatcher(model, device="cpu").plan.L == 256


def test_kernel_build_root(monkeypatch, tmp_path):
    """Builds go under the checkout's build/ by default, and under
    $H2R_TORCH_BUILD_DIR when that is set (importing the kernels module
    needs no CUDA)."""
    from halo2_regex_tpu_torch.ops import kernels

    monkeypatch.delenv("H2R_TORCH_BUILD_DIR", raising=False)
    root = kernels.build_root()
    assert root.parts[-2:] == ("build", "h2r_torch_kernels")
    assert (root.parent.parent / "halo2_regex_tpu_torch").is_dir()
    monkeypatch.setenv("H2R_TORCH_BUILD_DIR", str(tmp_path))
    assert kernels.build_root() == tmp_path
