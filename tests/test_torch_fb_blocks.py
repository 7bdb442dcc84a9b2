"""Match-only fb_only (B4) as its CUDA kernel computes it, on the CPU.

``csrc/bitplane_fb.cu``: a cluster of CS = min(8, ceil(L / 128)) blocks
owns 8 words; each thread ORs bnd & log over 4 consecutive positions of
each 128-position step its rank takes (bnd = en & ~en_next); two shuffle
rounds, shared memory and rank 0 (which gets every rank's partial in its
shared memory) reduce them, and rank 0 adds the empty-string term
~en[0] on each first-state bit.  ``bitplane.fb_blocks_plain`` runs those
steps in torch ops; here it is held bit for bit (integer outputs:
tolerance 0, dtypes included) against the JAX package's ``_make_fb_only``
(Pallas interpret mode) and ``fb_only_plain``: on the ``from:`` model and
a 2-def model, at L = 36, 100 and 1000 (L_pad 1024, clusters of 8), with
lengths 0, 31, 32, 33 and L among the strings and random log planes, at
NWS = 1 and 2, and at lengths where each rank takes several steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import halo2_regex_tpu as J
from halo2_regex_tpu.models import zoo as jzoo
from halo2_regex_tpu.ops.bitplane import BitplaneMatcher as JaxMatcher

import halo2_regex_tpu_torch as T
from halo2_regex_tpu_torch.ops import bitplane as bp

from test_torch_bitplane import _build

LENGTHS = [36, 100, 1000]
NAMES = ["from", "two_def"]
EDGES = [0, 31, 32, 33]


def _inputs(plan, NWS, seed, lengths=None):
    """Random log planes [NWS, SB, L_pad, 128] and the enable plane of
    lengths that hold the tile edges, 0 and L (or ``lengths``)."""
    rng = np.random.default_rng(seed)
    L, n = plan.L_pad, NWS * bp.TILE
    if lengths is None:
        top = plan.L  # the model's max_chars_size: no string is longer
        lengths = rng.integers(0, top + 1, size=n).astype(np.int32)
        lengths[: n // 2] = np.resize(np.array(EDGES + [top], np.int32), n // 2)
        rng.shuffle(lengths)
    logs = rng.integers(-2**31, 2**31, size=(NWS, plan.sb_sum, L, 128)).astype(np.int32)
    en = bp.enable_plane(bp.len_table(torch.from_numpy(lengths)), L).numpy()
    return logs, en


@pytest.fixture(scope="module")
def jax_fbs():
    """(name, L, NWS) -> the inputs and the interpret-mode JAX fb_only's
    output, computed once per module."""
    out = {}
    for name in NAMES:
        for L in LENGTHS:
            jm = JaxMatcher(_build(J, jzoo, name, L), columns="match", interpret=True)
            plan = bp.make_plan(_build(T, T.zoo, name, L), "match")
            assert (jm.L_pad, jm._sb_sum) == (plan.L_pad, plan.sb_sum)
            for NWS in ((1, 2) if L in (36, 1000) and name == "from" else (1,)):
                logs, en = _inputs(plan, NWS, L + NWS)
                fb = jm._make_fb_only(NWS)(jnp.asarray(logs), jnp.asarray(en)[:, None])
                out[name, L, NWS] = (plan, logs, en, np.array(fb))
    return out


def _check(plan, logs, en, want=None):
    got = bp.fb_blocks_plain(plan, torch.from_numpy(logs), torch.from_numpy(en))
    plain = bp.fb_only_plain(plan, torch.from_numpy(logs), torch.from_numpy(en))
    assert got.dtype == plain.dtype == torch.int32
    assert got.shape == (logs.shape[0], plan.n_defs, 8, 128)
    assert torch.equal(got, plain)
    if want is not None:
        assert want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("name", NAMES)
def test_fb_blocks_matches_jax(jax_fbs, name, L):
    """One word row (NWS = 1): the kernel's steps equal the JAX kernel and
    fb_only_plain."""
    _check(*jax_fbs[name, L, 1])


@pytest.mark.parametrize("L", [36, 1000])
def test_fb_blocks_two_rows(jax_fbs, L):
    """NWS = 2: the second row's words and their own position 0."""
    _check(*jax_fbs["from", L, 2])


@pytest.mark.parametrize("first", [None, 0b10101])
@pytest.mark.parametrize("fill", ["empty", "full", "one", "mixed"])
def test_fb_blocks_edge_batches(fill, first):
    """Every string empty (only the first-state term), every string full
    length (the boundary at the last position), every string one byte
    (the boundary at position 0, where the empty term must stay off), and
    a mix.  The compiled models' first states are 0, so the empty term
    adds nothing there; with ``first`` the plan's first states are set to
    0b10101 (and their log bits 0, 2, 4 must carry ~en[0])."""
    plan = bp.make_plan(_build(T, T.zoo, "two_def", 100), "match")
    if first is not None:
        plan = dataclasses.replace(plan, first_states=(first,) * plan.n_defs)
        assert plan.first_bit(1, 2) and not plan.first_bit(1, 1)
    n = bp.TILE
    if fill == "mixed":
        lengths = np.resize(np.array([0, 1, 31, 32, 33, plan.L], np.int32), n)
    else:
        lengths = np.full(n, {"empty": 0, "full": plan.L, "one": 1}[fill], np.int32)
    logs, en = _inputs(plan, 1, 3, lengths)
    _check(plan, logs, en)


@pytest.mark.parametrize("L", [129, 1280, 2100])
def test_fb_blocks_several_steps(L):
    """L_pad 256 (a cluster of 2), 1280 (8 ranks, 10 steps) and 2176 (8
    ranks, 17 steps: ranks take up to three): each rank's strided steps."""
    plan = bp.make_plan(_build(T, T.zoo, "from", L), "match")
    _check(plan, *_inputs(plan, 1, L))
