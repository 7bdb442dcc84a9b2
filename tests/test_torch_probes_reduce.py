"""bitop_carry's reduce form (P16) and lane_gather's pow form (P6): their
torch twins against the plain versions, on the CPU.

- ``bitop_carry_reduce_plain`` (the positions split as
  ``carry_geometry`` splits them, each warp's run ORed, the runs folded in
  the kernel's order, then st0 & ~ that) equals ``bitop_carry_plain`` (the
  probe's recurrence, position by position) over string groups, word
  counts (a multiple of 4 and not: the 4-byte path's geometry), chunk
  lengths, every read count from 1 to lc, zero, seeded and all-ones starts
  and class words of all ones and all zeros;
- the split covers every position read once, fills the card at E's shape,
  leaves no rank without a position, and the kernel's walk of a run
  (chunk and position in it kept by increments, 8 loads a batch) reads
  the rows the twin reads;
- ``lane_gather_pow_plain`` (binary exponentiation, ``pow_rounds``) equals
  ``lane_gather_plain`` at 0 to 1025 steps in both stores;
- a slice's OR dropped and a squaring too many are told apart;
- the CPU entry points take the plain versions in every form.

The probes' own outputs (interpret-mode JAX) are held in
tests/test_torch_probes_t2a.py (E) and tests/test_torch_probes_table.py
(the gather loops); the kernels run only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from halo2_regex_tpu_torch.probes import probe_tpu as p1
from halo2_regex_tpu_torch.probes import probe_tpu20 as p20

# ------------------------------------------------------------ bitop_carry


def _carry(NB, L, nws, seed, start, cls_kind):
    rng = np.random.default_rng(seed)
    if cls_kind == "random":
        cls = rng.integers(0, 2**31, size=(NB, L, 1, nws, 128)).astype(np.int32)
    else:
        cls = np.full((NB, L, 1, nws, 128), -1 if cls_kind == "ones" else 0, np.int32)
    if start == "zero":
        st0 = np.zeros((1, nws, 128), np.int32)
    elif start == "ones":
        st0 = np.full((1, nws, 128), -1, np.int32)
    else:
        st0 = rng.integers(-(2**31), 2**31, size=(1, nws, 128), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(cls), torch.from_numpy(st0)


@pytest.mark.parametrize("start", ["zero", "seeded", "ones"])
@pytest.mark.parametrize("NB,L,nws,lc", [(2, 64, 1, 16), (1, 96, 3, 32), (3, 48, 2, 48),
                                         (2, 40, 1, 8)])
def test_reduce_twin_equals_plain_every_read_count(NB, L, nws, lc, start):
    cls, st0 = _carry(NB, L, nws, L + lc, start, "random")
    for steps in range(1, lc + 1):
        want = p20.bitop_carry_plain(cls, st0, lc, steps)
        got = p20.bitop_carry_reduce_plain(cls, st0, lc, steps)
        assert got.dtype == torch.int32 and torch.equal(got, want), steps


@pytest.mark.parametrize("cls_kind", ["ones", "zeros"])
@pytest.mark.parametrize("start", ["zero", "seeded", "ones"])
@pytest.mark.parametrize("steps", [1, 5, 32])
def test_reduce_twin_on_constant_classes(cls_kind, start, steps):
    """All-ones class words clear every bit of the start; all-zeros keep it."""
    cls, st0 = _carry(2, 128, 2, 7, start, cls_kind)
    got = p20.bitop_carry_reduce_plain(cls, st0, 32, steps)
    assert torch.equal(got, p20.bitop_carry_plain(cls, st0, 32, steps))
    want = torch.zeros_like(got) if cls_kind == "ones" else st0.expand(2, 2, 128).reshape(got.shape)
    assert torch.equal(got, want)


def test_reduce_twin_at_the_probe_shape():
    """E's [2, 1024, 1, 8, 128] (31 random bits a word, so the OR of 1024
    words is all ones below the sign bit) in both modes, and a view that
    is not 16-byte aligned (the 4-byte path's geometry)."""
    cls, st0 = p20.carry_inputs(p20.L, p20.NWS, seed=3)
    for steps in (1, p20.LC):
        want = p20.bitop_carry_plain(cls, st0, p20.LC, steps)
        assert torch.equal(p20.bitop_carry_reduce_plain(cls, st0, p20.LC, steps), want)
    flat = torch.empty(cls.numel() + 1, dtype=torch.int32)
    odd = flat[1:].view(cls.shape)
    odd.copy_(cls)
    assert p20.carry_vec(odd, st0) == 1 and p20.carry_vec(cls, st0) == 4
    assert torch.equal(p20.bitop_carry_reduce_plain(odd, st0, p20.LC, 3),
                       p20.bitop_carry_plain(cls, st0, p20.LC, 3))


@pytest.mark.parametrize("NB,NW,L,lc,steps,vec", [
    (2, 1024, 1024, 128, 128, 4), (2, 1024, 1024, 128, 1, 4), (2, 1024, 8192, 128, 128, 4),
    (1, 384, 96, 32, 7, 4), (3, 130, 64, 16, 16, 1), (2, 1024, 1024, 128, 128, 1),
    (65535, 128, 16, 16, 3, 4), (1, 128, 4096, 1, 1, 4)])
def test_geometry_covers_every_position_once(NB, NW, L, lc, steps, vec):
    geo = p20.carry_geometry(NB, NW, L, lc, steps, vec)
    assert geo["n_pos"] == L // lc * steps
    assert 1 <= geo["cluster"] <= min(p20.CARRY_MAX_CLUSTER, geo["n_pos"])
    assert geo["tiles"] * 32 * vec >= NW > (geo["tiles"] - 1) * 32 * vec
    # the kernel's own per_rank and per_warp (csrc/probe_tpu20.cu launch_reduce)
    assert geo["per_rank"] == -(-geo["n_pos"] // geo["cluster"])
    assert geo["per_warp"] == -(-geo["per_rank"] // p20.CARRY_WARPS)
    slices = p20.carry_slices(geo)
    assert len(slices) == geo["cluster"] * p20.CARRY_WARPS
    covered = [p for _r, _w, lo, hi in slices for p in range(lo, hi)]
    assert covered == list(range(geo["n_pos"]))  # once each, in fold order
    assert all(any(hi > lo for r2, _w, lo, hi in slices if r2 == r) for r in range(geo["cluster"]))
    assert geo["blocks"] == NB * geo["tiles"] * geo["cluster"]


def test_geometry_fills_the_card():
    """Every position at E's shape: 16 clusters of 16 blocks (two an SM on
    132), a batch of 8 loads a warp; at 64 MiB the same blocks, 8 batches a
    warp; one read a chunk (8 positions): one block a tile, a position a
    warp, no cluster; a rank takes at least a batch a warp between."""
    every = p20.carry_geometry(2, 1024, 1024, 128, 128, 4)
    assert every["blocks"] >= 132 and every["cluster"] == 16 and every["per_warp"] == 8
    one = p20.carry_geometry(2, 1024, 1024, 128, 1, 4)
    assert one["cluster"] == 1 and one["per_warp"] == 1 and one["blocks"] == 2 * 8
    big = p20.carry_geometry(2, 1024, 8192, 128, 128, 4)
    assert big["blocks"] >= 132 and big["per_warp"] == 64
    for n_pos in (64, 65, 128, 129, 512, 1000):
        geo = p20.carry_geometry(2, 1024, n_pos, 1, 1, 4)
        assert geo["cluster"] == min(16, max(1, n_pos // 64))
        assert geo["per_warp"] >= p20.CARRY_BATCH or geo["cluster"] == 1


@pytest.mark.parametrize("L,lc,steps", [(1024, 128, 128), (1024, 128, 1), (96, 32, 7),
                                        (64, 16, 5), (40, 8, 8)])
def test_kernel_walk_reads_the_twins_rows(L, lc, steps):
    """Each warp's loop as csrc/probe_tpu20.cu writes it (j, i from lo,
    kept by increments; batches of 8 loads, those at p + k >= hi skipped)
    reads the rows the twin reads, in the same order."""
    geo = p20.carry_geometry(2, 256, L, lc, steps, 4)
    p = torch.arange(geo["n_pos"])
    rows = (p // steps * lc + p % steps).tolist()
    for _rank, _warp, lo, hi in p20.carry_slices(geo):
        j, i = lo // steps, lo % steps
        walked = []
        for q in range(lo, hi, 8):
            for k in range(8):
                if q + k < hi:
                    walked.append(j * lc + i)
                i += 1
                if i == steps:
                    i, j = 0, j + 1
        assert walked == rows[lo:hi]


def test_reduce_twin_mutant_is_told_apart(monkeypatch):
    """One warp's run dropped from the fold changes the output."""
    cls, st0 = _carry(2, 256, 1, 5, "ones", "random")
    want = p20.bitop_carry_plain(cls, st0, 64, 64)
    assert torch.equal(p20.bitop_carry_reduce_plain(cls, st0, 64, 64), want)
    slices = p20.carry_slices

    def drop_one(geo):
        out = slices(geo)
        rank, warp, lo, _hi = out[3]
        out[3] = (rank, warp, lo, lo)
        return out

    monkeypatch.setattr(p20, "carry_slices", drop_one)
    # a position's bits set only in the dropped run
    cls2 = cls.clone()
    cls2[:] = 0
    lo = slices(p20.carry_geometry(2, 128, 256, 64, 64, 4))[3][2]
    cls2[:, lo] = -1
    assert not torch.equal(p20.bitop_carry_reduce_plain(cls2, st0, 64, 64),
                           p20.bitop_carry_plain(cls2, st0, 64, 64))


@pytest.mark.parametrize("form", [None, "reduce", "serial"])
def test_carry_cpu_entry_point_takes_the_plain_version(form):
    cls, st0 = p20.carry_inputs(128, 1, seed=4)
    assert torch.equal(p20.bitop_carry(cls, st0, 32, 32, form), p20.bitop_carry_plain(cls, st0, 32, 32))


def test_carry_forms():
    assert p20.carry_form(None) == "reduce" and p20.CARRY_FORMS == ("reduce", "serial")
    cls, st0 = p20.carry_inputs(128, 1)
    with pytest.raises(ValueError, match="form"):
        p20.bitop_carry(cls, st0, 32, 1, "tree")
    with pytest.raises(ValueError, match="lc"):
        p20.bitop_carry_reduce_plain(cls, st0, 48)
    with pytest.raises(ValueError, match="st0"):
        p20.bitop_carry_reduce_plain(cls, st0[:, :, :64])


# ------------------------------------------------------------ lane_gather

STEPS = [0, 1, 2, 3, 5, 127, 128, 1023, 1024, 1025]


def test_pow_rounds():
    assert p1.pow_rounds(0) == [] and p1.pow_rounds(1) == ["apply"]
    assert p1.pow_rounds(1024) == ["square"] * 10 + ["apply"]
    assert p1.pow_rounds(5) == ["apply", "square", "square", "apply"]
    for s in STEPS:  # one square a bit past the lowest, one apply a set bit
        r = p1.pow_rounds(s)
        assert r.count("apply") == bin(s).count("1")
        assert r.count("square") == max(s.bit_length() - 1, 0)


@pytest.mark.parametrize("store", p1.STORES)
@pytest.mark.parametrize("steps", STEPS)
def test_pow_twin_equals_plain(steps, store):
    g, f = p1.gather_inputs(6, seed=steps + 1)
    want = p1.lane_gather_plain(g, f, steps, store)
    got = p1.lane_gather_pow_plain(g, f, steps, store)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(p1.lane_gather(g, f, steps, store, "pow"), want)  # the CPU entry point
    assert torch.equal(p1.lane_gather(g, f, steps, store, "serial"), want)


def test_pow_twin_one_step_takes_any_g():
    """One step squares nothing: g's values need not be indices."""
    g, f = p1.gather_inputs(4, seed=2)
    big = g * 1000 + 128
    assert torch.equal(p1.lane_gather_pow_plain(big, f, 1), torch.gather(big, 1, f.long()))
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        p1.lane_gather_pow_plain(big, f, 2)


def test_pow_twin_mutant_is_told_apart(monkeypatch):
    """A squaring too many changes the output."""
    g, f = p1.gather_inputs(8, seed=11)
    want = p1.lane_gather_plain(g, f, 1024)
    rounds = p1.pow_rounds
    monkeypatch.setattr(p1, "pow_rounds", lambda s: ["square"] + rounds(s))
    assert not torch.equal(p1.lane_gather_pow_plain(g, f, 1024), want)


def test_gather_forms():
    assert p1.GATHER_FORMS == ("pow", "serial")
    assert p1.gather_form(None, 1024) == "pow" and p1.gather_form(None, 1) == "serial"
    assert p1.gather_form(None, 0) == "serial" and p1.gather_form("pow", 1) == "pow"
    g, f = p1.gather_inputs(2)
    with pytest.raises(ValueError, match="form"):
        p1.lane_gather(g, f, 4, "shared", "doubling")
