"""The quad-word pack (B5 pack_raw, B6 tpack) as its CUDA kernel computes it, on the CPU.

``csrc/bitplane_pack_words.cuh`` is one kernel for both layouts: a block
stages a tile of 32 words x 32 positions of the quad words by the
layout's strides, lane = word computes the byte-bit planes (the SWAR
8 x 8 transpose) and the class circuits, and the enable plane comes from
each string's run mask over the tile's 32 positions and one warp bit
transpose.  ``bitplane.pack_words_tiles_plain`` runs those steps in torch
ops; here it is held bit for bit (integer outputs: tolerance 0, dtypes
included) against the JAX package's ``_make_pack`` and ``_make_tpack``
(Pallas interpret mode) and against ``pack_plain`` / ``tpack_plain``: on
the ``from:`` model in every mode (binary and one-hot class planes, class
stage off, en_pack off for the raw rows), at L = 36, 100 and 1000 (L_pad
1024: partial tiles at the end), with lengths 0, 31, 32, 33 and L among
the strings, at NWS = 1 and 2, and on a 2-def model.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher
from halo2_regex_tpu.ops.bitplane import raw_quads as jax_raw_quads
from halo2_regex_tpu.ops.bitplane import tile_corpus as jax_tile_corpus

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp
from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

from test_torch_bitplane import _build

LENGTHS = [36, 100, 1000]
EDGES = [0, 31, 32, 33]
# the JAX constructor's knobs and the port's of each mode
MODES = {
    "binary": {},
    "onehot": dict(class_stage="onehot"),
    "off": dict(class_stage=False),
    "en_off": dict(en_pack=False),
}
TILED_MODES = ["binary", "onehot", "off"]  # the tiled contract always packs the enable plane


def _corpus(n, length, seed):
    """Random bytes; lengths cycle through the tile edges and ``length``
    before random ones, so every word holds each of them."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(0, 256, size=(n, length)).astype(np.uint8)
    lengths = rng.integers(0, length + 1, size=n).astype(np.int32)
    lengths[: n // 2] = np.resize(np.array(EDGES + [length], np.int32), n // 2)
    rng.shuffle(lengths)
    return chars, lengths


def _len_wb(lengths):
    NW = lengths.shape[0] // 32
    return lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(NW // 128, 128, 32)


def _jax_pack(jmodel, chars, lengths, mode, tiled, NWS):
    """The interpret-mode JAX pack kernel's (class planes, enable plane or
    None) on the batch: ``_make_tpack`` of the tiled words, else
    ``_make_pack`` of the raw quad rows."""
    L = chars.shape[1]
    lw = jnp.asarray(_len_wb(lengths))
    if tiled:
        jm = JaxMatcher(jmodel, columns="witness", input_layout="tiled", interpret=True,
                        **MODES[mode])
        bits, en = jm._make_tpack(NWS)(jnp.asarray(jax_tile_corpus(chars, jm.L_pad)), lw)
        return np.array(bits), np.array(en)
    jm = JaxMatcher(jmodel, columns="witness", interpret=True, qpack=False, **MODES[mode])
    R = jax_raw_quads(jnp.asarray(chars), jm.L_pad).reshape(jm.L_pad, 8, NWS, 128)
    if jm._en_in_pack:
        bits, en = jm._make_pack(NWS)(R, lw)
        return np.array(bits), np.array(en)
    return np.array(jm._make_pack(NWS)(R)), None


@pytest.fixture(scope="module")
def jax_packs():
    """(L, layout) -> the batch and each mode's JAX pack outputs, on one
    seeded 4096-string batch (NWS = 1) of the from: model, computed once
    per module."""
    out = {}
    for L in LENGTHS:
        chars, lengths = _corpus(4096, L, L)
        jmodel = jzoo.email_headers_model(max_chars_size=L, headers=("from",))
        for tiled in (False, True):
            modes = TILED_MODES if tiled else list(MODES)
            out[L, tiled] = {"chars": chars, "lengths": lengths}
            out[L, tiled].update({m: _jax_pack(jmodel, chars, lengths, m, tiled, 1) for m in modes})
    return out


def _plan(model, mode, tiled):
    return bp.make_plan(model, "witness", knobs=BitplaneKnobs.from_env(qpack=False, **MODES[mode]),
                        tiled=tiled)


def _equal(got, want, what):
    if want is None:
        assert got is None, what
        return
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def _twin_and_plain(plan, chars, lengths, tiled):
    """(the twin's outputs, the plain version's) on the batch."""
    ch = torch.from_numpy(chars)
    len_wb = bp.len_table(torch.from_numpy(lengths))
    if tiled:
        x = torch.from_numpy(bp.tile_corpus(chars, plan.L_pad))
        return (bp.pack_words_tiles_plain(plan, x, len_wb, tiled=True),
                bp.tpack_plain(plan, x, len_wb))
    x = bp.raw_quads(ch, plan.L_pad)
    return bp.pack_words_tiles_plain(plan, x, len_wb), bp.pack_plain(plan, x, len_wb)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_pack_words_raw_matches_jax(jax_packs, mode, L):
    """Raw quad rows (pack_raw's layout) in every mode: the kernel's steps
    equal the JAX ``_make_pack`` and ``pack_plain``."""
    s = jax_packs[L, False]
    plan = _plan(T.zoo.email_headers_model(max_chars_size=L, headers=("from",)), mode, False)
    (bits, en), (pb, pe) = _twin_and_plain(plan, s["chars"], s["lengths"], False)
    _equal(bits, s[mode][0], "bits_stack")
    _equal(en, s[mode][1], "en_plane")
    _equal(bits, pb.numpy(), "bits_stack vs pack_plain")
    _equal(en, None if pe is None else pe.numpy(), "en_plane vs pack_plain")


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("mode", TILED_MODES)
def test_pack_words_tiled_matches_jax(jax_packs, mode, L):
    """Pretiled words (tpack's layout) in each class-stage mode: the
    kernel's steps equal the JAX ``_make_tpack`` and ``tpack_plain``."""
    s = jax_packs[L, True]
    plan = _plan(T.zoo.email_headers_model(max_chars_size=L, headers=("from",)), mode, True)
    (bits, en), (pb, pe) = _twin_and_plain(plan, s["chars"], s["lengths"], True)
    _equal(bits, s[mode][0], "bits_stack")
    _equal(en, s[mode][1], "en_plane")
    _equal(bits, pb.numpy(), "bits_stack vs tpack_plain")
    _equal(en, pe.numpy(), "en_plane vs tpack_plain")


@pytest.mark.parametrize("tiled", [False, True])
def test_pack_words_two_rows(tiled):
    """NWS = 2 (8192 strings): the tiles of the second word row take its
    own strides (raw rows: the row's 128 words at offset 128 in each
    position's 256; tiled: the second [8, L_pad, 128] block), against the
    JAX kernel on two rows and the plain version."""
    L = 100
    chars, lengths = _corpus(8192, L, 7)
    jmodel = jzoo.email_headers_model(max_chars_size=L, headers=("from",))
    want_bits, want_en = _jax_pack(jmodel, chars, lengths, "binary", tiled, 2)
    plan = _plan(T.zoo.email_headers_model(max_chars_size=L, headers=("from",)), "binary", tiled)
    (bits, en), (pb, pe) = _twin_and_plain(plan, chars, lengths, tiled)
    assert bits.shape == (L, plan.kp, 2, 128)
    _equal(bits, want_bits, "bits_stack")
    _equal(en, want_en, "en_plane")
    assert torch.equal(bits, pb) and torch.equal(en, pe)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("mode", ["binary", "onehot"])
def test_pack_words_two_defs(mode, tiled):
    """A 2-def model (regex1 + regex2: both defs' class planes stacked),
    against the JAX kernel and the plain version."""
    L = 64
    chars, lengths = _corpus(4096, L, 11)
    want_bits, want_en = _jax_pack(_build(J, jzoo, "two_def", L), chars, lengths, mode, tiled, 1)
    plan = _plan(_build(T, T.zoo, "two_def", L), mode, tiled)
    assert plan.n_defs == 2
    (bits, en), (pb, pe) = _twin_and_plain(plan, chars, lengths, tiled)
    _equal(bits, want_bits, "bits_stack")
    _equal(en, want_en, "en_plane")
    assert torch.equal(bits, pb) and torch.equal(en, pe)
