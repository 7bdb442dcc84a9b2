"""The steps of K1 qpack as the CUDA kernel computes them, on the CPU.

``csrc/bitplane_pack.cu`` stages four strings' bytes at a time through a
4 x 4 byte transpose (``__byte_perm``) into the quad words of each
position, builds the 8 byte-bit planes with the SWAR 8 x 8 bit transpose
(``h2r_byte_planes``), and builds the enable plane from each string's run
mask over a 32-position tile, (1 << clamp(len - l0, 0, 32)) - 1, turned
by one 32 x 32 bit transpose across a warp (five shuffle rounds) into the
enable words.  ``bitplane.bytes4x4``, ``byte_planes_swar``,
``enable_runs`` and ``qpack_tiles_plain`` run those steps in torch ops;
here they are held bit for bit (integer outputs: tolerance 0, dtypes
included) against ``qpack_plain`` and the JAX package's ``_make_qpack``
(Pallas interpret mode) on the from: model, in every mode (binary and
one-hot class planes, class stage off, en_pack off), with string lengths
0, 31, 32 and 33 (a 32-position tile's edges) and L among them, and at
lengths L = 17, 36 and 100 that end inside a tile.
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
from halo2_regex_tpu_torch.ops.knobs import BitplaneKnobs

L = 64
NB = 4096  # one row of 128 words (NWS = 1)
NW = NB // 32
EDGES = [0, 31, 32, 33]
# (JAX constructor knobs, the port's knobs) of each mode
MODES = {
    "binary": {},
    "onehot": dict(class_stage="onehot"),
    "off": dict(class_stage=False),
    "en_off": dict(en_pack=False),
}


def _corpus(n, length, seed):
    """Random bytes; lengths cycle through the tile edges and ``length``
    before random ones, so every word holds each of them."""
    rng = np.random.default_rng(seed)
    chars = rng.integers(0, 256, size=(n, length)).astype(np.uint8)
    edges = [e for e in EDGES + [length] if e <= length]
    lengths = rng.integers(0, length + 1, size=n).astype(np.int32)
    lengths[: n // 2] = np.resize(np.array(edges, np.int32), n // 2)
    rng.shuffle(lengths)
    return chars, lengths


def _plan(length, mode):
    model = T.zoo.email_headers_model(max_chars_size=length, headers=("from",))
    return bp.make_plan(model, "witness", knobs=BitplaneKnobs.from_env(**MODES[mode]))


@pytest.fixture(scope="module")
def jax_qpacks():
    """mode -> the JAX qpack kernel's class planes and enable plane (None
    with en_pack off) on one seeded batch, computed once per module."""
    chars, lengths = _corpus(NB, L, 5)
    len_wb = lengths.reshape(8, NW, 4).transpose(1, 2, 0).reshape(1, 128, 32)
    ch = jnp.asarray(chars).reshape(8, NW, 4, L)
    jmodel = jzoo.email_headers_model(max_chars_size=L, headers=("from",))
    out = {"chars": chars, "lengths": lengths}
    for mode, kw in MODES.items():
        jm = JaxMatcher(jmodel, columns="witness", interpret=True, **kw)
        if jm._en_in_pack:
            bits, en = jm._make_qpack(1)(ch, jnp.asarray(len_wb))
        else:
            bits, en = jm._make_qpack(1)(ch), None
        out[mode] = np.array(bits), None if en is None else np.array(en)
    return out


def _equal(got, want, what):
    if want is None:
        assert got is None, what
        return
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("mode", list(MODES))
def test_qpack_tiles_matches_jax(jax_qpacks, mode):
    """The kernel's steps end to end equal the JAX qpack and qpack_plain."""
    chars = torch.from_numpy(jax_qpacks["chars"])
    len_wb = bp.len_table(torch.from_numpy(jax_qpacks["lengths"]))
    plan = _plan(L, mode)
    bits, en = bp.qpack_tiles_plain(plan, chars, len_wb)
    want_bits, want_en = jax_qpacks[mode]
    _equal(bits, want_bits, "bits_stack")
    _equal(en, want_en, "en_plane")
    pb, pe = bp.qpack_plain(plan, chars, len_wb)
    assert torch.equal(bits, pb) and (en is None) == (pe is None)
    if en is not None:
        assert torch.equal(en, pe)


@pytest.mark.parametrize("length", [17, 36, 100])
@pytest.mark.parametrize("mode", list(MODES))
def test_qpack_tiles_partial_tile(mode, length):
    """At lengths that end inside a 32-position tile (and, at 17, inside a
    4-position group) the kernel's steps equal qpack_plain."""
    chars, lengths = _corpus(NB, length, 6)
    chars, len_wb = torch.from_numpy(chars), bp.len_table(torch.from_numpy(lengths))
    plan = _plan(length, mode)
    got = bp.qpack_tiles_plain(plan, chars, len_wb)
    want = bp.qpack_plain(plan, chars, len_wb)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None) == (mode == "en_off")
    if got[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("length", [1, 31, 32, 33, 64, 100])
def test_enable_runs_equal_enable_plane(jax_qpacks, length):
    """The run masks and the warp transpose give the enable plane, for
    every length 0..L at L = ``length`` (and at L = 64 JAX's)."""
    rng = np.random.default_rng(length)
    lengths = rng.integers(0, length + 1, size=NB).astype(np.int32)
    lengths[: length + 1] = np.arange(length + 1)
    len_wb = bp.len_table(torch.from_numpy(lengths))
    got = bp.enable_runs(len_wb, length)
    assert got.dtype == torch.int32 and got.shape == (1, length, 128)
    assert torch.equal(got, bp.enable_plane(len_wb, length))
    if length == L:
        lw = bp.len_table(torch.from_numpy(jax_qpacks["lengths"]))
        _equal(bp.enable_runs(lw, L), jax_qpacks["binary"][1], "en_plane")


def test_byte_planes_swar_equal_shift_and_or():
    """The SWAR transpose gives the 8 x 8 shift-and-OR's byte-bit planes on
    random quad words (sign bits included)."""
    rng = np.random.default_rng(3)
    rows = [torch.from_numpy(rng.integers(-2**31, 2**31, size=(5, 3, 128)).astype(np.int32))
            for _ in range(8)]
    got = bp.byte_planes_swar(rows)
    want = bp._byte_planes(rows)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_bytes4x4_transposes_bytes():
    """``__byte_perm``'s selectors of the staging: o[s] byte j = v[j] byte
    s, on random words."""
    rng = np.random.default_rng(4)
    v = rng.integers(0, 2**32, size=(4, 64), dtype=np.uint64)
    o = bp.bytes4x4([torch.from_numpy(x.astype(np.int64)) for x in v])
    for s in range(4):
        for j in range(4):
            want = (v[j] >> np.uint64(8 * s)) & np.uint64(0xFF)
            got = (o[s].numpy() >> 8 * j) & 0xFF
            np.testing.assert_array_equal(got, want.astype(np.int64))
