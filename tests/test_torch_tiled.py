"""The PyTorch port's tiled input contract against the JAX package.

Mirrors tests/test_tiled_input.py: ``tile_corpus`` (the native C++ packer
and the numpy version, padding included) against the JAX package's;
``tpack_plain`` against the interpret-mode JAX ``_make_tpack`` (B6) and the
tiled ``post_plain`` against the interpret-mode ``_make_post`` with the
quad words as its extra input (B3's tiled mode), stage by stage on the same
numpy inputs; the tiled witness and match emissions end to end against the
JAX tiled matcher and the port's [B, L] matcher (the ``from:`` model at
L=128, B=96, and regex1 + regex2 at L=64); ``match_one``; and the
refusals.  All outputs are integers: tolerance 0, dtypes included.  The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher
from halo2_regex_tpu.ops.bitplane import tile_corpus as jax_tile_corpus

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch import native
from halo2_regex_tpu_torch.ops import bitplane as bp

from test_torch_bitplane import MAX_LEN, _build, assert_equal, corpus

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo

MODELS = ["regex3", "two_def", "from"]
LANE = bp.LANE


def _plant_corpus(rng, B, L, plant=b"from:alice@gmail.com\r\n"):
    """tests/test_tiled_input.py's corpus: random printable bytes, ragged
    lengths, a matching line in every seventh string."""
    chars = rng.integers(32, 127, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=(B,)).astype(np.int32)
    for i in range(0, B, 7):
        chars[i, : len(plant)] = np.frombuffer(plant, np.uint8)
        lengths[i] = len(plant)
    return chars, lengths


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    """Run a test with the native C++ packer and with the numpy version."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available(), "g++ is on this machine's PATH"
    return request.param


def test_tile_corpus_matches_raw_quads_tiling(packer):
    rng = np.random.default_rng(1)
    B, L = 32 * LANE, 64
    chars = rng.integers(0, 256, size=(B, L)).astype(np.uint8)
    tiled = bp.tile_corpus(chars, L)
    assert tiled.dtype == np.int32 and tiled.shape == (1, 8, L, LANE)
    rq = bp.raw_quads(torch.from_numpy(chars), L).numpy()
    np.testing.assert_array_equal(tiled, rq.transpose(2, 1, 0, 3))
    np.testing.assert_array_equal(tiled, jax_tile_corpus(chars, L))


def test_tile_corpus_pads_batch_and_length(packer):
    rng = np.random.default_rng(2)
    chars = rng.integers(0, 256, size=(5, 16)).astype(np.uint8)
    tiled = bp.tile_corpus(chars, 32)
    assert tiled.shape == (1, 8, 32, LANE)
    # strings beyond B and positions beyond L read as zero bytes
    full = np.zeros((32 * LANE, 32), np.uint8)
    full[:5, :16] = chars
    np.testing.assert_array_equal(tiled, bp.tile_corpus(full, 32))
    np.testing.assert_array_equal(tiled, jax_tile_corpus(chars, 32))
    # a batch one past a word group: two groups, the second nearly empty
    odd = rng.integers(0, 256, size=(32 * LANE + 3, 8)).astype(np.uint8)
    np.testing.assert_array_equal(bp.tile_corpus(odd, 8), jax_tile_corpus(odd, 8))
    with pytest.raises(ValueError, match="L_pad"):
        bp.tile_corpus(chars, 8)


# ---------------------------------------------------------------------------
# stage by stage: plain versions vs the JAX kernels on the same inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return {n: (_build(J, jzoo, n), _build(T, T.zoo, n)) for n in MODELS}


@pytest.fixture(scope="module")
def jax_tiled_stages(models):
    """Each model's JAX tiled intermediates on one seeded 4096-string batch
    (NWS = 1): tpack, the fused scan and the tiled post kernel."""
    out = {}
    for seed, n in enumerate(MODELS):
        jm = JaxMatcher(models[n][0], columns="witness", input_layout="tiled", interpret=True)
        chars, lengths = corpus(n, 4096, 40 + seed)
        NW = 4096 // 32
        len_wb = lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(1, 128, 32)
        tiled = jax_tile_corpus(chars, jm.L_pad)
        bits, en = jm._make_tpack(1)(jnp.asarray(tiled), jnp.asarray(len_wb))
        logs = jm._make_scan_fused(1)(bits)
        g4, fb = jm._make_post(1)(logs, en[:, None], jnp.asarray(tiled))
        out[n] = {k: np.array(v) for k, v in dict(
            tiled=tiled, len_wb=len_wb, bits=bits, en=en, logs=logs, g4=g4, fb=fb).items()}
    return out


@pytest.fixture(scope="module")
def plans(models):
    return {n: bp.make_plan(models[n][1], "witness", tiled=True) for n in MODELS}


@pytest.mark.parametrize("name", MODELS)
def test_tpack_plain_matches_jax(plans, jax_tiled_stages, name):
    s = jax_tiled_stages[name]
    bits, en = bp.tpack_plain(plans[name], torch.from_numpy(s["tiled"]),
                              torch.from_numpy(s["len_wb"]))
    assert_equal(bits, s["bits"], "bits_stack")
    assert_equal(en, s["en"], "en_plane")


@pytest.mark.parametrize("name", MODELS)
def test_post_tiled_plain_matches_jax(plans, jax_tiled_stages, name):
    """The byte groups (masked characters among them) and the boundary
    planes; the plan's groups are the JAX matcher's."""
    s = jax_tiled_stages[name]
    plan = plans[name]
    assert plan.wgroups[-1] == (("masked_characters_pre", 0, 8),)
    g4, fb = bp.post_plain(plan, torch.from_numpy(s["logs"]), torch.from_numpy(s["en"]),
                           torch.from_numpy(s["tiled"]))
    assert_equal(g4, s["g4"], "g4")
    assert_equal(fb, s["fb"], "fb")
    assert s["g4"][:, -8:].any()  # the masked characters light up


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert_equal(got[k], np.asarray(want[k]), k)


@pytest.mark.parametrize("columns", ["witness", "match"])
def test_tiled_bit_exact_email_model(columns):
    jmodel = jzoo.email_headers_model(max_chars_size=128, headers=("from",))
    tmodel = T.zoo.email_headers_model(max_chars_size=128, headers=("from",))
    chars, lengths = _plant_corpus(np.random.default_rng(3), 96, 128)
    jtl = JaxMatcher(jmodel, interpret=True, columns=columns, input_layout="tiled")
    tl = T.BitplaneMatcher(tmodel, columns=columns, input_layout="tiled", device="cpu")
    assert (tl.L_pad, tl.input_layout) == (jtl.L_pad, "tiled")
    tiled = bp.tile_corpus(chars, tl.L_pad)
    got = tl(tiled, lengths)
    _assert_dicts_equal(got, jtl(jax_tile_corpus(chars, jtl.L_pad), lengths))
    std = T.BitplaneMatcher(tmodel, columns=columns, device="cpu")(chars, lengths)
    _assert_dicts_equal(got, {k: v.numpy() for k, v in std.items()})
    assert got["match_ok"].sum() == 14


def test_tiled_bit_exact_multi_def(models):
    jmodel, tmodel = models["two_def"]
    chars, lengths = _plant_corpus(np.random.default_rng(4), 64, MAX_LEN,
                                   plant=b"email was meant for @y. Also for x.")
    jtl = JaxMatcher(jmodel, interpret=True, columns="witness", input_layout="tiled")
    tl = T.BitplaneMatcher(tmodel, columns="witness", input_layout="tiled", device="cpu")
    got = tl(bp.tile_corpus(chars, tl.L_pad), lengths)
    _assert_dicts_equal(got, jtl(jax_tile_corpus(chars, jtl.L_pad), lengths))
    assert got["match_ok"].any()


def test_tiled_run_plain_matches_routed(models):
    """``run(..., plain=True)`` (the reference chip_smoke holds the kernels
    to) equals the routed run on the CPU, for a tiled batch of two word
    groups whose lengths cover only part of it."""
    tmodel = models["from"][1]
    m = T.BitplaneMatcher(tmodel, columns="witness", input_layout="tiled", device="cpu")
    chars, lengths = corpus("from", 4099, 41)
    tiled = torch.from_numpy(bp.tile_corpus(chars, m.L_pad))
    assert tiled.shape[0] == 2
    lens = torch.from_numpy(lengths)
    a = bp.run(m.plan, m.tables(), tiled, lens, plain=True)
    b = m(tiled, lens)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["states"].shape == (4099, 1, MAX_LEN + 1)


def test_tiled_match_one():
    model = T.zoo.email_headers_model(max_chars_size=128, headers=("from",))
    tl = T.BitplaneMatcher(model, columns="witness", input_layout="tiled", device="cpu")
    res = tl.match_one(b"from:alice@gmail.com\r\n")
    assert bool(res["match_ok"])
    assert bytes(res["masked_characters"][res["masked_characters"] != 0]) == b"alice@gmail.com"
    verdict = T.BitplaneMatcher(model, columns="match", input_layout="tiled",
                                device="cpu").match_one(b"from:bob\r\n")
    assert not bool(verdict["match_ok"])


# ---------------------------------------------------------------------------
# refusals: the JAX package's errors, type and words
# ---------------------------------------------------------------------------


def test_tiled_rejects_unsupported_modes(models, monkeypatch):
    model = models["from"][1]
    with pytest.raises(ValueError, match="tiled"):
        T.BitplaneMatcher(model, input_layout="tiled", device="cpu")
    with pytest.raises(ValueError, match="tiled"):
        T.BitplaneMatcher(model, columns="witness", post="xla", input_layout="tiled",
                          device="cpu")
    with pytest.raises(ValueError, match="emit"):
        T.BitplaneMatcher(model, columns="witness", emit="planes", input_layout="tiled",
                          device="cpu")
    with pytest.raises(ValueError, match="input_layout"):
        T.BitplaneMatcher(model, input_layout="rowmajor", device="cpu")
    monkeypatch.setenv("H2R_EMIT", "kdecode")
    with pytest.raises(ValueError, match="resolved emit='kdecode'"):
        T.BitplaneMatcher(model, columns="witness", input_layout="tiled", device="cpu")
    with pytest.raises(ValueError, match="resolved emit='direct'"):
        T.BitplaneMatcher(model, columns="witness", emit="direct", input_layout="tiled",
                          device="cpu")
    # match mode emits no witness fields: the environment's emission is
    # ignored, as in the JAX matcher
    m = T.BitplaneMatcher(model, columns="match", input_layout="tiled", device="cpu")
    assert (m.plan.emit, m.plan.tiled) == ("planes", True)
    assert bool(m.match_one(b"xx\r\nfrom:bob@x.yz\r\n")["match_ok"])


def test_tiled_rejects_bad_inputs(models):
    m = T.BitplaneMatcher(models["regex3"][1], columns="match", input_layout="tiled",
                          device="cpu")
    tiled = torch.zeros((1, 8, MAX_LEN, LANE), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 4096"):
        m(tiled, np.zeros(4097, np.int32))
    with pytest.raises(ValueError, match="tile_corpus"):
        m(tiled[:, :, :32], np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="quad words, and only it"):
        plan = bp.make_plan(models["regex3"][1], "witness", tiled=True)
        z = torch.zeros((1, plan.sb_sum, MAX_LEN, LANE), dtype=torch.int32)
        bp.post_plain(plan, z, z[:, 0])
