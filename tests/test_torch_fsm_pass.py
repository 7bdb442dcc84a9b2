"""The one-pass form of the mask FSM kernel, on the CPU.

``csrc/table_fsm.cu`` runs both mask FSMs of a large batch in one launch:
its forward walk reads ids, start and endf once, writes fwd and packs the
backward op of each position into 2 bits (16 positions a word); that op
needs the next position's ids and start, so it is known one step late, and
the last one comes from the backward carry.  The backward walk reads only
the codes.  ``pallas_scan.fsm_pass_plain`` runs those walks in torch ops;
here it is held bit for bit (integer outputs: tolerance 0, dtypes
included) against ``fsm_plain`` and against the JAX package's B10 kernel
(``PallasMatcher._fsm_kernel``, run through ``_make_fsm`` in Pallas
interpret mode) on seeded planes: one and four defs, L = 1, 15, 16, 17
and 70, empty strings (all-zero columns), every direction alone and both,
and windows with carries on both sides.  Its codes are held against the
backward ops computed position by position in numpy.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from halo2_regex_tpu.ops.pallas_scan import PallasMatcher as JaxPallas

from halo2_regex_tpu_torch.ops import pallas_scan as ps

TB = 8  # strings: one interpret-mode grid step of the JAX kernel
LENGTHS = [1, 15, 16, 17, 70]
DEFS = [1, 4]
NONE = (None, None, None)


def _planes(n_defs, L, seed, B=TB):
    """Seeded ids / start / endf [n_defs, L, B] int32 with small ids, so
    neighbours often agree, and the last two strings empty (zero columns,
    as the tag stage leaves a string of length 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 3, size=(n_defs, L, B)).astype(np.int32)
    start = (rng.random((n_defs, L, B)) < 0.3).astype(np.int32)
    endf = (rng.random((n_defs, L, B)) < 0.3).astype(np.int32)
    for a in (ids, start, endf):
        a[..., B - 2:] = 0
    return ids, start, endf


def _jax_fsm(n_defs, L):
    """The JAX ``_make_fsm`` pallas_call for ``n_defs`` defs at length
    ``L``: its kernel body reads only the matcher's L, batch tile and def
    count, so those are all the stand-in carries."""
    m = types.SimpleNamespace(L=L, batch_tile=TB, n_defs=n_defs, interpret=True,
                              _vmem_params=None)
    m._fsm_kernel = functools.partial(JaxPallas._fsm_kernel, m)
    return JaxPallas._make_fsm(m, TB)


@pytest.fixture(scope="module")
def jax_fsms():
    """(n_defs, L) -> the seeded planes and the JAX kernel's fwd and bwd,
    computed once per module."""
    out = {}
    for i, (nd, L) in enumerate((nd, L) for nd in DEFS for L in LENGTHS):
        planes = _planes(nd, L, 30 + i)
        fwd, bwd = _jax_fsm(nd, L)(*(jnp.asarray(a) for a in planes))
        out[nd, L] = planes, np.array(fwd), np.array(bwd)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fresh(L, B):
    return torch.full((L, B), -7, dtype=torch.int32)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("n_defs", DEFS)
def test_fsm_pass_plain_matches_jax(jax_fsms, n_defs, L):
    """Both FSMs over the whole L (null carries) equal the JAX kernel's and
    ``fsm_plain``'s."""
    (ids, st, ef), jf, jb = jax_fsms[n_defs, L]
    ids, st, ef = _t(ids), _t(st), _t(ef)
    fwd, bwd = _fresh(L, TB), _fresh(L, TB)
    codes = ps.fsm_pass_plain(ids, st, ef, NONE, NONE, 0, L, fwd, bwd)
    assert codes.shape == (-(-L // 16), TB) and codes.dtype == torch.int32
    np.testing.assert_array_equal(fwd.numpy(), jf)
    np.testing.assert_array_equal(bwd.numpy(), jb)
    assert fwd.dtype == bwd.dtype == torch.int32 and jf.dtype == jb.dtype == np.int32
    pf, pb = _fresh(L, TB), _fresh(L, TB)
    ps.fsm_plain(False, ids, st, ef, None, None, None, 0, L, pf)
    ps.fsm_plain(True, ids, st, ef, None, None, None, 0, L, pb)
    assert torch.equal(fwd, pf) and torch.equal(bwd, pb)
    assert not fwd[:, TB - 2:].any() and not bwd[:, TB - 2:].any()  # the empty strings
    if L >= 15:
        assert fwd.any() and bwd.any()


@pytest.mark.parametrize("dirs", [1, 2, 3])
@pytest.mark.parametrize("window", [(5, 50), (16, 32), (69, 1), (0, 17), (53, 17)])
@pytest.mark.parametrize("n_defs", DEFS)
def test_fsm_pass_plain_windows(n_defs, window, dirs):
    """A window [p0, p0 + LS) of L = 70 with carries on each side that has
    a neighbour (entries, ids and flag rows), each direction alone and
    both, equals ``fsm_plain``; rows outside the window stay untouched."""
    L, B = 70, 37
    p0, LS = window
    ids, st, ef = (_t(a) for a in _planes(n_defs, L, 7, B))
    rng = np.random.default_rng(8)
    fc = bc = NONE
    if p0 > 0:
        fc = (_t(rng.integers(0, 2, B).astype(np.int32)), ids[:, p0 - 1], ef[:, p0 - 1])
    if p0 + LS < L:
        bc = (_t(rng.integers(0, 2, B).astype(np.int32)), ids[:, p0 + LS], st[:, p0 + LS])
    want_f, want_b = _fresh(L, B), _fresh(L, B)
    ps.fsm_plain(False, ids, st, ef, *fc, p0, LS, want_f)
    ps.fsm_plain(True, ids, st, ef, *bc, p0, LS, want_b)
    fwd = _fresh(L, B) if dirs & 1 else None
    bwd = _fresh(L, B) if dirs & 2 else None
    codes = ps.fsm_pass_plain(ids, st, ef, fc, bc, p0, LS, fwd, bwd)
    assert (codes is None) == (bwd is None)
    for got, want in ((fwd, want_f), (bwd, want_b)):
        if got is not None:
            assert torch.equal(got, want)
            assert bool((got[:p0] == -7).all() and (got[p0 + LS:] == -7).all())


@pytest.mark.parametrize("L", [17, 70])
def test_fsm_pass_codes_hold_backward_ops(L):
    """Code k of a string holds the backward ops of positions p0 + 16 k ..
    p0 + 16 k + 15 at bits 2 i (0 hold, 1 set, 2 reset), the op of p from
    the ids and endf at p and the ids and start at p + 1 (the backward
    carry past the window), computed here one position at a time."""
    B, p0, LS = 11, 3, L - 4
    ids, st, ef = _planes(2, L, 9, B)
    carry = (None, _t(ids[:, p0 + LS]), _t(st[:, p0 + LS]))
    codes = ps.fsm_pass_plain(_t(ids), _t(st), _t(ef), NONE, carry, p0, LS, None,
                              _fresh(L, B)).numpy().view(np.uint32)
    si, ss, se = ids.sum(0), st.sum(0), ef.sum(0)
    for b in range(B):
        for q in range(LS):
            p = p0 + q
            changed = si[p + 1, b] != si[p, b]
            op = 1 if changed and se[p, b] > 0 else (2 if changed and ss[p + 1, b] > 0 else 0)
            assert (codes[q // 16, b] >> 2 * (q % 16)) & 3 == op, (b, q)
        last = LS - 1
        assert int(codes[last // 16, b]) >> 2 * (last % 16) + 2 == 0  # none past the window
